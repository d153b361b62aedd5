"""Spectrum metrics and error measures (counterpart of
fftlab/utils/metrics.py): `magnitude`, `phase` and
`power_spectrum_bins` as torch ops on the tensor's device (other input
goes to `device`, the card unless the caller passes "cpu"); the error
measures, the interpolated peak and the centroid on the host in numpy,
as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.core.types import as_tensor, to_host


def magnitude(X, device="cuda") -> torch.Tensor:
    """|X|."""
    return torch.abs(as_tensor(X, device))


def phase(X, device="cuda") -> torch.Tensor:
    """arg(X)."""
    return torch.angle(as_tensor(X, device))


def power_spectrum_bins(X, device="cuda") -> torch.Tensor:
    """|X|^2."""
    X = as_tensor(X, device)
    if X.is_complex():
        return X.real ** 2 + X.imag ** 2
    return X ** 2


def max_error(a, b) -> float:
    """Max absolute complex error."""
    return float(np.max(np.abs(to_host(a) - to_host(b))))


def rms_error(a, b) -> float:
    """RMS complex error."""
    d = np.abs(to_host(a) - to_host(b))
    return float(np.sqrt(np.mean(d * d)))


def snr_db(signal, reference) -> float:
    """SNR of `signal` against the ground truth `reference`, in dB."""
    reference = to_host(reference)
    noise = to_host(signal) - reference
    p_sig = np.sum(np.abs(reference) ** 2)
    p_noise = np.sum(np.abs(noise) ** 2)
    if p_noise == 0:
        return float("inf")
    return float(10.0 * np.log10(p_sig / p_noise))


def find_peak_interpolated(mag, lo: int = 1, hi: int | None = None):
    """The peak bin of a 1D magnitude array with parabolic interpolation:
    (refined_bin, refined_magnitude)."""
    mag = np.asarray(to_host(mag), dtype=np.float64)
    n = len(mag)
    hi = hi if hi is not None else n // 2
    hi = min(hi, n - 1)
    if hi <= lo:
        return float(np.argmax(mag[: hi + 1])), float(np.max(mag[: hi + 1]))
    k = int(lo + np.argmax(mag[lo : hi + 1]))
    if k == 0 or k == n - 1:
        return float(k), float(mag[k])
    a, b, c = mag[k - 1], mag[k], mag[k + 1]
    denom = a - 2 * b + c
    delta = 0.0 if denom == 0 else 0.5 * (a - c) / denom
    peak = b - 0.25 * (a - c) * delta
    return float(k + delta), float(peak)


def spectral_centroid(mag, sample_rate: float, n: int) -> float:
    """The power-weighted mean frequency."""
    mag = np.asarray(to_host(mag)[: n // 2], dtype=np.float64)
    freqs = np.arange(len(mag)) * sample_rate / n
    p = mag * mag
    total = np.sum(p)
    return float(np.sum(freqs * p) / total) if total > 0 else 0.0
