"""Host-side float64 radix-2 FFT in numpy (counterpart of
fftlab/core/hostfft.py).

Runs only at plan time, to build constants such as the Bluestein kernel
spectrum; never on the device. The same code as the JAX package's, so the
constants both packages hand their transforms are equal bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np

from fftlab_torch.core.bitrev import bit_reverse_indices
from fftlab_torch.core.twiddle import chirp_np
from fftlab_torch.core.types import Direction, is_power_of_two, log2_int


def host_fft_pow2(x: np.ndarray, direction: int = Direction.FORWARD) -> np.ndarray:
    """Vectorized iterative radix-2 DIT over the last axis, complex128.

    Forward unscaled; inverse applies 1/n."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise ValueError(f"host_fft_pow2 requires power-of-two n, got {n}")
    if n == 1:
        return x.copy()
    d = float(int(direction))
    y = np.take(x, bit_reverse_indices(n), axis=-1)
    batch = y.shape[:-1]
    for s in range(1, log2_int(n) + 1):
        m = 1 << s
        w = np.exp(2j * np.pi * d * np.arange(m // 2) / m)
        y = y.reshape(*batch, n // m, m)
        even = y[..., : m // 2]
        t = y[..., m // 2 :] * w
        y = np.concatenate([even + t, even - t], axis=-1)
    y = y.reshape(*batch, n)
    if int(direction) == Direction.INVERSE:
        y = y / n
    return y


@functools.lru_cache(maxsize=None)
def bluestein_kernel_spectrum_np(n: int, m: int, direction: int) -> np.ndarray:
    """Forward FFT (size m) of the Bluestein circular chirp kernel b, where
    b[0..n-1] = conj(c[0..n-1]) and b[m-t] = conj(c[t]), with
    c[k] = exp(i*pi*direction*k^2/n). complex128, plan-time constant."""
    c = np.conj(chirp_np(n, direction))
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = c
    if n > 1:
        b[m - (n - 1) :] = c[1:][::-1]
    return host_fft_pow2(b, Direction.FORWARD)
