"""Bluestein / chirp-z FFT for any n on split planes (counterpart of
fftlab/algos/bluestein.py:67-139).

With c[k] = exp(i*pi*dir*k^2/n),
    X[k] = c[k] * sum_j (x[j]*c[j]) * conj(c[k-j]),
a linear convolution of a[j] = x[j]*c[j] with conj(c), evaluated
circularly at the power of two m = next_pow2(2n-1). That convolution is
the FFT -> B -> IFFT sandwich at size m with B the spectrum of the chirp
kernel, so it rides `plan.dispatch.spectral_filter_auto`: the row kernel
for m up to 16K, the four-launch two-pass sandwich for m in 2^15..2^21
(n up to about 2^20), the tensor-op sandwich above.

The chirp and B are float64 plan-time constants, cached per
(n, direction): each call costs one sandwich and two modulations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.algos.split_stockham import _twiddle_split, permute_response
from fftlab_torch.core.hostfft import bluestein_kernel_spectrum_np
from fftlab_torch.core.twiddle import chirp_np
from fftlab_torch.core.types import FORWARD, Direction, next_power_of_two


@functools.lru_cache(maxsize=64)
def _kernel_planes_np(n: int, m: int, direction: int, dtype_str: str):
    """The convolution kernel's spectrum B as (re, im) planes of
    `dtype_str`, in natural order and in the digit-reversed order the
    tensor-op sandwich consumes."""
    rdtype = np.dtype(dtype_str)
    B = bluestein_kernel_spectrum_np(n, m, direction)
    Br = B.real.astype(rdtype)
    Bi = B.imag.astype(rdtype)
    Br_p, Bi_p = permute_response(Br, Bi, m)
    return Br, Bi, Br_p, Bi_p


@functools.lru_cache(maxsize=8)
def _device_constants(n: int, direction: int, dtype: torch.dtype,
                      device: torch.device):
    """(chirp planes, B planes, digit-reversed B planes) on `device`; about
    20 MB of device memory per entry at m = 2^20, hence the small cache."""
    m = next_power_of_two(2 * n - 1)
    c = chirp_np(n, direction)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    Br, Bi, Br_p, Bi_p = _kernel_planes_np(n, m, direction, np_dtype.str)
    return ((as_t(c.real), as_t(c.imag)), (as_t(Br), as_t(Bi)),
            (as_t(Br_p), as_t(Bi_p)))


def _conv_sandwich_split(ar, ai, Br, Bi, m: int, permuted=None):
    """The circular convolution IFFT_m(FFT_m(a) * B), 1/m scaled: the
    spectral-filter sandwich at size m through the shared dispatcher. B's
    bin order matters only inside the multiply, so the digit-reversed copy
    serves the tensor-op route unchanged."""
    from fftlab_torch.plan.dispatch import spectral_filter_auto

    if int(ar.shape[-1]) != m:
        raise ValueError(f"convolution planes have {ar.shape[-1]} points, want {m}")
    return spectral_filter_auto(ar, ai, Br, Bi, permuted=permuted)


def bluestein_fft_split(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Chirp-z FFT of any length n on split planes [..., n]. Forward
    unscaled, inverse 1/n."""
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    if n == 1:
        return xr, xi
    m = next_power_of_two(2 * n - 1)
    (cr, ci), (Br, Bi), permuted = _device_constants(
        n, int(direction), xr.dtype, xr.device)
    ar, ai = _twiddle_split(xr, xi, cr, ci)  # a = x * c
    ar = F.pad(ar, (0, m - n))
    ai = F.pad(ai, (0, m - n))
    vr, vi = _conv_sandwich_split(ar, ai, Br, Bi, m, permuted=permuted)
    yr, yi = _twiddle_split(vr[..., :n], vi[..., :n], cr, ci)
    if direction == Direction.INVERSE:
        return yr * (1.0 / n), yi * (1.0 / n)
    return yr, yi
