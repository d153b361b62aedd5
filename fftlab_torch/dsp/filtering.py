"""Frequency-domain FFT filtering (counterpart of
fftlab/dsp/filtering.py:26-171).

Responses are designed on the host in float64 with the JAX package's
code: ideal brick-wall responses with negative frequencies mirrored,
raised-cosine transition bands, and FIR design by frequency sampling.
`fft_filter` and `fft_filter_custom` run IFFT(H .* FFT(x)) on complex
tensors through `cfft` (the tensor-op Stockham by default, any registry
transform on request); the split-plane `fft_filter_split` runs the
sandwich of `plan.dispatch.spectral_filter_auto`. Input that is not a
tensor goes to the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from fftlab_torch.algos._common import table_on
from fftlab_torch.core.hostfft import host_fft_pow2
from fftlab_torch.core.types import (Direction, as_tensor, complex_dtype_for,
                                     next_power_of_two)
from fftlab_torch.core.window import hamming
from fftlab_torch.plan.dispatch import spectral_filter_auto


class FilterType(enum.Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    BANDSTOP = "bandstop"
    CUSTOM = "custom"


@dataclasses.dataclass(frozen=True)
class FilterParams:
    filter_type: FilterType
    cutoff_low: float  # Hz (or cycles/window if sample_rate == n)
    cutoff_high: float = 0.0  # upper edge for band filters
    sample_rate: float = 1.0
    transition_width: float = 0.0  # Hz; 0 = ideal brick wall


def ideal_response(n: int, params: FilterParams) -> np.ndarray:
    """Brick-wall |H[k]| over the full FFT grid, with negative frequencies
    (k > n/2) mirrored."""
    k = np.arange(n)
    freq = k * params.sample_rate / n
    freq = np.where(k > n // 2, params.sample_rate - freq, freq)
    ft = params.filter_type
    if ft == FilterType.LOWPASS:
        h = (freq <= params.cutoff_low).astype(np.float64)
    elif ft == FilterType.HIGHPASS:
        h = (freq >= params.cutoff_low).astype(np.float64)
    elif ft == FilterType.BANDPASS:
        h = ((freq >= params.cutoff_low) & (freq <= params.cutoff_high)).astype(np.float64)
    elif ft == FilterType.BANDSTOP:
        h = ((freq < params.cutoff_low) | (freq > params.cutoff_high)).astype(np.float64)
    else:
        raise ValueError("CUSTOM responses: pass H directly to the sandwich "
                         "(plan.dispatch.spectral_filter_auto)")
    return h


def apply_transition_band(h: np.ndarray, n: int, params: FilterParams) -> np.ndarray:
    """Smooth each 0/1 edge with a raised cosine `transition_width` Hz
    wide, mirrored onto the negative frequencies so the impulse response
    stays real."""
    if params.transition_width <= 0:
        return h
    half_bins = max(int(round(params.transition_width / 2 * n / params.sample_rate)), 1)
    out = h.copy()
    half = n // 2
    edges = [k for k in range(1, half + 1) if h[k] != h[k - 1]]
    for e in edges:
        rising = h[e] > h[e - 1]
        for i in range(-half_bins, half_bins + 1):
            k = e + i
            if 0 <= k <= half:
                x = (i + half_bins) / (2 * half_bins)  # 0..1 across the band
                c = 0.5 * (1 - np.cos(np.pi * x))  # raised cosine 0 -> 1
                out[k] = c if rising else 1.0 - c
    for k in range(half + 1, n):
        out[k] = out[n - k]
    return out


def design_response(n: int, params: FilterParams) -> np.ndarray:
    """Full-grid real |H[k]| including transition bands."""
    return apply_transition_band(ideal_response(n, params), n, params)


def fft_filter(x, params: FilterParams, cfft=None, device="cuda"):
    """Filter a block: IFFT(H .* FFT(x)) with the response of `params` on
    x's n-point grid, designed on the host once per (n, params, dtype,
    device). x: real or complex [..., n]; returns the input's domain."""
    x = as_tensor(x, device)
    H = table_on(design_response, int(x.shape[-1]), params,
                 dtype=complex_dtype_for(x.dtype), device=x.device)
    return fft_filter_custom(x, H, cfft)


def fft_filter_custom(x, h, cfft=None, device="cuda"):
    """Filter with an arbitrary n-bin frequency response H[k] (numpy or a
    tensor; the CUSTOM type), cast to x's complex dtype on x's device."""
    if cfft is None:
        from fftlab_torch.algos.stockham import stockham_fft as cfft
    x = as_tensor(x, device)
    was_real = not x.is_complex()
    cdtype = complex_dtype_for(x.dtype)
    X = cfft(x.to(cdtype), Direction.FORWARD)
    H = as_tensor(h, x.device).to(device=x.device, dtype=cdtype)
    y = cfft(X * H, Direction.INVERSE)
    return y.real if was_real else y


def design_fir(num_taps: int, params: FilterParams, cfft=None) -> np.ndarray:
    """FIR design by frequency sampling on the host in float64: sample H
    on a num_taps grid, inverse DFT, centre (circular shift), Hamming
    window. Returns the real taps. `cfft` is the JAX signature's and
    unused there too: the design runs on the host."""
    n = num_taps
    h_mag = design_response(n, params)
    if n == next_power_of_two(n):
        imp = host_fft_pow2(h_mag.astype(np.complex128), Direction.INVERSE)
    else:
        k = np.arange(n)
        Finv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
        imp = Finv @ h_mag.astype(np.complex128)
    imp = np.roll(np.real(imp), n // 2)  # linear-phase centring
    return imp * hamming(n, periodic=False)


def fft_filter_split(xr: torch.Tensor, xi: torch.Tensor, params: FilterParams):
    """Block filter on split planes [..., n]: ifft(fft(x) * H) with the
    plan-time real response H of `params`, through
    `spectral_filter_auto`. Returns (yr, yi). Two real channels packed as
    (xr=ch0, xi=ch1) come back as the two filtered channels: a real H is
    Hermitian, so filtering commutes with taking Re and Im."""
    n = int(xr.shape[-1])
    h = design_response(n, params).astype(np.float32)
    return spectral_filter_auto(xr, xi, h, np.zeros(n, np.float32))
