"""Welch power spectrum and magnitude-squared coherence on split planes
(counterpart of fftlab/dsp/spectrum.py:219-273).

Both average windowed periodograms of segments taken by `stft_split`,
so the default segmenting (window 256, 50% overlap: hop 128) runs the
`stft_frames` kernel on a CUDA tensor. The complex-dtype periodogram,
welch_psd, coherence and the correlations take a complex FFT and are
not ported yet (ROADMAP Queue 1 items 8-9).
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.core.window import get_window, power_gain
from fftlab_torch.dsp.stft import stft_split
from fftlab_torch.kernels._common import check_real


def _segments(n: int, window_size: int, overlap: float) -> tuple[int, int]:
    """(hop, number of whole segments) of Welch's segmenting."""
    hop = max(int(window_size * (1.0 - overlap)), 1)
    return hop, max((n - window_size) // hop + 1, 1)


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
    scale = 1.0 / (sample_rate * window_size * power_gain(get_window(window, window_size)))
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if window_size % 2 == 0:
        dbl[-1] = 1.0
    dbl_t = torch.from_numpy(dbl).to(device=p.device, dtype=p.dtype)
    psd = torch.mean(p, dim=0) * scale * dbl_t
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
