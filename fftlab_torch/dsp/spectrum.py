"""Power-spectrum estimation: periodogram, Welch, autocorrelation,
cross-correlation, coherence and spectral statistics (counterpart of
fftlab/dsp/spectrum.py).

The complex-dtype functions take a complex transform as `cfft` (the
tensor-op Stockham by default, as in the JAX package). The split-plane
ones take no complex dtype: Welch and coherence average windowed
periodograms of segments taken by `stft_split`, so the default
segmenting (window 256, 50% overlap: hop 128) runs the `stft_frames`
kernel on a CUDA tensor; the two correlations run their FFTs through
`plan.dispatch.fft_split_auto`. Input that is not a tensor goes to the
card unless the caller passes `device="cpu"`; a tensor stays on its
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.algos._common import table_on
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import (FORWARD, INVERSE, as_tensor, complex_dtype_for,
                                     next_power_of_two, to_host)
from fftlab_torch.core.window import get_window, power_gain
from fftlab_torch.dsp.stft import stft_split, window_tensor
from fftlab_torch.kernels._common import check_real
from fftlab_torch.plan.dispatch import fft_split_auto


def _cfft():
    from fftlab_torch.algos.stockham import stockham_fft

    return stockham_fft


def _one_sided(h: int, n: int) -> np.ndarray:
    """The one-sided doubling: 2 but at DC and, for even n, Nyquist."""
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if n % 2 == 0:
        dbl[-1] = 1.0
    return dbl


def _doubling(h: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return table_on(_one_sided, h, n, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=16)
def _named_power_gain(window: str, n: int) -> float:
    return power_gain(get_window(window, n))


def _power_gain(window, n: int) -> float:
    """sum(w^2)/n of the window, once per named window and n."""
    if isinstance(window, str):
        return _named_power_gain(window, n)
    return power_gain(get_window(window, n))


def periodogram(x, sample_rate: float = 1.0, window="hann", cfft=None, device="cuda"):
    """One-sided PSD of real input [..., n]: (freqs [n/2+1] numpy,
    psd [..., n/2+1]), with the window's power correction sum(w^2)/n and
    the one-sided doubling but at DC and Nyquist."""
    if cfft is None:
        cfft = _cfft()
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    cdtype = complex_dtype_for(x.dtype)
    X = cfft((x * window_tensor(window, n, x)).to(cdtype), FORWARD)
    h = n // 2 + 1
    p = (X.real ** 2 + X.imag ** 2)[..., :h]
    p = p * (1.0 / (sample_rate * n * _power_gain(window, n)))
    p = p * _doubling(h, n, p)
    return np.arange(h) * sample_rate / n, p


def _segments(n: int, window_size: int, overlap: float) -> tuple[int, int]:
    """(hop, number of whole segments) of Welch's segmenting."""
    hop = max(int(window_size * (1.0 - overlap)), 1)
    return hop, max((n - window_size) // hop + 1, 1)


def welch_psd(x, sample_rate: float = 1.0, window_size: int = 256,
              overlap: float = 0.5, window="hann", cfft=None, device="cuda"):
    """Welch's method: the mean of the windowed periodograms of the whole
    overlapping segments, all framed as one strided view."""
    x = as_tensor(x, device)
    hop, n_seg = _segments(int(x.shape[-1]), window_size, overlap)
    segments = frame_signal_strided(x, window_size, hop, n_seg)
    freqs, p = periodogram(segments, sample_rate, window, cfft)
    return freqs, torch.mean(p, dim=-2)


def autocorrelation(x, cfft=None, device="cuda"):
    """Biased autocorrelation via FFT: pad to next_pow2(2n), |X|^2,
    inverse. Returns lags 0..n-1 normalized so r[0] = 1."""
    if cfft is None:
        cfft = _cfft()
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    X = cfft(F.pad(x.to(complex_dtype_for(x.dtype)), (0, m - n)), FORWARD)
    r = cfft(X * torch.conj(X), INVERSE)[..., :n].real
    return r / torch.clamp_min(r[..., :1], 1e-30)


def cross_correlation(x, y, cfft=None, device="cuda"):
    """Cross-correlation via conj(X)*Y: the two-sided sequence of length
    2n-1 with zero lag at index n-1, r_xy[tau] = sum x[t]*y[t+tau]."""
    if cfft is None:
        cfft = _cfft()
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    cdtype = complex_dtype_for(torch.result_type(x, y))
    X = cfft(F.pad(x.to(cdtype), (0, m - n)), FORWARD)
    Y = cfft(F.pad(y.to(cdtype), (0, m - n)), FORWARD)
    r = cfft(torch.conj(X) * Y, INVERSE).real
    # negative lags live at the tail of the circular result
    return torch.cat([r[..., m - (n - 1):], r[..., :n]], dim=-1)


def coherence(x, y, sample_rate: float = 1.0, window_size: int = 256,
              overlap: float = 0.5, window="hann", cfft=None, device="cuda"):
    """Magnitude-squared coherence C_xy = |S_xy|^2 / (S_xx * S_yy) over
    Welch segments: (freqs [h] numpy, coherence [..., h]), h =
    window_size//2+1. Needs at least two segments."""
    if cfft is None:
        cfft = _cfft()
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    hop, n_seg = _segments(int(x.shape[-1]), window_size, overlap)
    if n_seg < 2:
        raise ValueError("coherence needs >= 2 Welch segments for averaging")
    cdtype = complex_dtype_for(torch.result_type(x, y))
    w = window_tensor(window, window_size, torch.empty(0, dtype=cdtype, device=x.device))

    def seg_fft(s):
        sw = frame_signal_strided(s, window_size, hop, n_seg) * w
        return cfft(sw.to(cdtype), FORWARD)

    X, Y = seg_fft(x), seg_fft(y)
    h = window_size // 2 + 1
    Sxy = torch.mean(torch.conj(X) * Y, dim=-2)[..., :h]
    Sxx = torch.mean(X.abs() ** 2, dim=-2)[..., :h]
    Syy = torch.mean(Y.abs() ** 2, dim=-2)[..., :h]
    freqs = np.arange(h) * sample_rate / window_size
    return freqs, Sxy.abs() ** 2 / torch.clamp_min(Sxx * Syy, 1e-30)


def spectral_stats(psd, freqs) -> dict:
    """Centroid, RMS bandwidth, 95% rolloff and total power of a 1D PSD,
    on the host in float64 (a tensor is read back from its device)."""
    p = to_host(psd).astype(np.float64)
    f = to_host(freqs).astype(np.float64)
    total = float(np.sum(p))
    if total <= 0:
        return {"centroid": 0.0, "bandwidth": 0.0, "rolloff_95": 0.0, "total_power": 0.0}
    centroid = float(np.sum(f * p) / total)
    bandwidth = float(np.sqrt(np.sum(((f - centroid) ** 2) * p) / total))
    cumsum = np.cumsum(p)
    rolloff = float(f[int(np.searchsorted(cumsum, 0.95 * total))])
    return {"centroid": centroid, "bandwidth": bandwidth, "rolloff_95": rolloff,
            "total_power": total}


def autocorrelation_split(x, device="cuda"):
    """Autocorrelation of a real float32 signal [..., n] on split planes:
    normalized lags 0..n-1, as `autocorrelation` (pad 2n, |X|^2,
    inverse), no complex dtype. Both FFTs of m = next_pow2(2n) points go
    through `plan.dispatch.fft_split_auto`, not the einsum `fft_split`
    the JAX function names: the same function, and on a CUDA tensor the
    route `select_split_impl(m)` names launches its kernels, `smem_rows`
    (`fft_rows`) at m of 8K..16K, `two_pass` (the `fourstep_pass1/2`
    pair) at 2^15..2^21 and `three_pass` at 2^22 and above, the einsum
    route elsewhere. At 16 x 2^20 the einsum route took 7.3 ms on the
    H100 where the two-pass pair took 0.25 ms (PERF.md)."""
    x = as_tensor(x, device).to(torch.float32)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    xp = F.pad(x, (0, m - n))
    Xr, Xi = fft_split_auto(xp, torch.zeros_like(xp), FORWARD)
    pw = Xr * Xr + Xi * Xi
    rr, _ = fft_split_auto(pw, torch.zeros_like(pw), INVERSE)
    r = rr[..., :n]
    return r / torch.clamp_min(r[..., :1], 1e-30)


def cross_correlation_split(x, y, device="cuda"):
    """Cross-correlation of two real float32 signals on split planes, the
    two-sided length 2n-1 sequence of `cross_correlation`: x and y packed
    as one complex transform (x -> re, y -> im), X and Y recovered by the
    Hermitian split, S = conj(X) Y, inverse. The two FFTs run through
    `fft_split_auto`, as in `autocorrelation_split`."""
    x = as_tensor(x, device).to(torch.float32)
    y = as_tensor(y, x.device).to(torch.float32)
    n = int(x.shape[-1])
    m = next_power_of_two(2 * n)
    Zr, Zi = fft_split_auto(F.pad(x, (0, m - n)), F.pad(y, (0, m - n)), FORWARD)
    # Z = X + iY with x, y real: X[k] = (Z[k] + conj(Z[-k]))/2,
    # Y[k] = (Z[k] - conj(Z[-k]))/(2i)
    Zr_m = torch.roll(torch.flip(Zr, (-1,)), 1, -1)  # Re Z[-k]
    Zi_m = torch.roll(torch.flip(Zi, (-1,)), 1, -1)  # Im Z[-k]
    Xr, Xi = (Zr + Zr_m) / 2, (Zi - Zi_m) / 2
    Yr, Yi = (Zi + Zi_m) / 2, (Zr_m - Zr) / 2
    Sr = Xr * Yr + Xi * Yi
    Si = Xr * Yi - Xi * Yr
    rr, _ = fft_split_auto(Sr, Si, INVERSE)
    return torch.cat([rr[..., m - (n - 1):], rr[..., :n]], dim=-1)


def welch_psd_split(x: torch.Tensor, sample_rate: float = 1.0,
                    window_size: int = 256, overlap: float = 0.5, window="hann"):
    """Welch PSD of a real float32 1D signal: (freqs [h] numpy, psd [h]
    tensor), h = window_size//2+1, the mean periodogram of the whole
    segments with the window's power correction and one-sided doubling."""
    check_real(x, "welch_psd_split")
    hop, n_seg = _segments(int(x.shape[-1]), window_size, overlap)
    Xr, Xi = stft_split(x[: (n_seg - 1) * hop + window_size], window_size, hop, window)
    h = window_size // 2 + 1
    p = (Xr * Xr + Xi * Xi)[:n_seg, :h]
    scale = 1.0 / (sample_rate * window_size * _power_gain(window, window_size))
    psd = torch.mean(p, dim=0) * scale * _doubling(h, window_size, p)
    return np.arange(h) * sample_rate / window_size, psd


def coherence_split(x: torch.Tensor, y: torch.Tensor, sample_rate: float = 1.0,
                    window_size: int = 256, overlap: float = 0.5, window="hann"):
    """Magnitude-squared coherence |S_xy|^2 / (S_xx S_yy) of two real
    float32 1D signals over Welch segments: (freqs [h] numpy, coherence
    [h] tensor). Needs at least two segments."""
    check_real(x, "coherence_split")
    check_real(y, "coherence_split")
    hop, n_seg = _segments(int(x.shape[-1]), window_size, overlap)
    if n_seg < 2:
        raise ValueError("coherence needs >= 2 Welch segments for averaging")
    cut = (n_seg - 1) * hop + window_size
    Xr, Xi = stft_split(x[:cut], window_size, hop, window)
    Yr, Yi = stft_split(y[:cut], window_size, hop, window)
    sxy_r = torch.mean(Xr * Yr + Xi * Yi, dim=0)
    sxy_i = torch.mean(Xr * Yi - Xi * Yr, dim=0)
    sxx = torch.mean(Xr * Xr + Xi * Xi, dim=0)
    syy = torch.mean(Yr * Yr + Yi * Yi, dim=0)
    h = window_size // 2 + 1
    freqs = np.arange(h) * sample_rate / window_size
    return freqs, (sxy_r ** 2 + sxy_i ** 2) / torch.clamp(sxx * syy, min=1e-30)
