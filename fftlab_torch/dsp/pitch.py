"""Pitch detection: spectral peak, harmonic product spectrum and
FFT autocorrelation, combined by an agreement vote (counterpart of
fftlab/dsp/pitch.py).

The detectors are batched: real frames [..., n] -> one pitch per frame
in Hz, one batched transform and a few reductions on the frames'
device. `detect_pitch` combines the three on one frame in a host
epilogue, as in the JAX package. Input that is not a tensor goes to the
card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.algos._common import table_on
from fftlab_torch.algos.real_fft import rfft
from fftlab_torch.core.types import as_tensor
from fftlab_torch.dsp.spectrum import autocorrelation
from fftlab_torch.dsp.stft import window_tensor

A4 = 440.0
NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


@functools.lru_cache(maxsize=1)
def note_table() -> list[tuple[str, float]]:
    """97 notes C0..C8 with equal-temperament frequencies; C0 = A4 *
    2^(-57/12)."""
    notes = []
    for i in range(97):
        # i semitones above C0; A4 is 57 semitones above C0
        notes.append((NOTE_NAMES[i % 12] + str(i // 12), A4 * 2.0 ** ((i - 57) / 12.0)))
    return notes


def freq_to_note(freq: float) -> tuple[str, float]:
    """Nearest note name and the offset from it in cents."""
    if freq <= 0:
        return ("?", 0.0)
    semis = 12.0 * np.log2(freq / A4) + 57.0  # semitones above C0
    idx = int(np.clip(round(semis), 0, 96))
    name, f_note = note_table()[idx]
    return (name, float(1200.0 * np.log2(freq / f_note)))


def _parabolic_refine(mag: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Quadratic-interpolated peak offset in [-0.5, 0.5] around bin k."""
    last = int(mag.shape[-1]) - 1
    at = lambda i: torch.gather(mag, -1, i.unsqueeze(-1)).squeeze(-1)
    a, b, c = at(torch.clamp(k - 1, 0, last)), at(k), at(torch.clamp(k + 1, 0, last))
    denom = a - 2 * b + c
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (a - c) / denom, torch.zeros_like(denom))
    return torch.clamp(delta, -0.5, 0.5)


def _band(size: int, lo: int, hi: int) -> np.ndarray:
    m = np.zeros(size)
    m[lo:hi] = 1.0
    return m


def _mask(size: int, lo: int, hi: int, like: torch.Tensor) -> torch.Tensor:
    """1 on [lo, hi), 0 elsewhere, in `like`'s dtype on its device."""
    return table_on(_band, size, lo, hi, dtype=like.dtype, device=like.device)


def _windowed_magnitude(x: torch.Tensor, window, cfft) -> torch.Tensor:
    return rfft(x * window_tensor(window, int(x.shape[-1]), x), cfft).abs()


def pitch_spectral_peak(x, sample_rate: float, window="hann", fmin: float = 20.0,
                        fmax: float | None = None, cfft=None, device="cuda"):
    """Spectral-peak pitch with parabolic interpolation: [..., n] real ->
    [...] Hz."""
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    mag = _windowed_magnitude(x, window, cfft)
    h = int(mag.shape[-1])
    if fmax is None:
        fmax = sample_rate / 2.0
    kmin = max(int(np.ceil(fmin * n / sample_rate)), 1)
    kmax = min(int(fmax * n / sample_rate), h - 1)
    mag = mag * _mask(h, kmin, kmax + 1, mag)
    k = torch.argmax(mag, dim=-1)
    return (k + _parabolic_refine(mag, k)) * (sample_rate / n)


def harmonic_product_spectrum(x, sample_rate: float, n_harmonics: int = 4,
                              window="hann", fmin: float = 20.0, cfft=None, device="cuda"):
    """HPS pitch: the spectrum times its 2x..Hx downsampled copies; the
    fundamental survives, the harmonics cancel."""
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    mag = _windowed_magnitude(x, window, cfft)
    m = int(mag.shape[-1]) // n_harmonics
    hps = mag[..., :m]
    for r in range(2, n_harmonics + 1):
        hps = hps * mag[..., : r * m : r][..., :m]
    kmin = max(int(np.ceil(fmin * n / sample_rate)), 1)
    hps = hps * _mask(m, kmin, m, hps)
    k = torch.argmax(hps, dim=-1)
    return (k + _parabolic_refine(hps, k)) * (sample_rate / n)


def pitch_autocorrelation(x, sample_rate: float, fmin: float = 50.0,
                          fmax: float = 2000.0, cfft=None, device="cuda"):
    """Autocorrelation pitch via FFT: the lag of the autocorrelation's
    peak inside [1/fmax, 1/fmin] is the period."""
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    r = autocorrelation(x, cfft)  # [..., n], r[0] = 1
    lag_min = max(int(sample_rate / fmax), 1)
    lag_max = min(int(sample_rate / fmin), n - 1)
    mask = _mask(n, lag_min, lag_max + 1, r)
    rm = r * mask - (1 - mask)
    k = torch.argmax(rm, dim=-1)
    lag = k + _parabolic_refine(rm, k)
    return torch.where(lag > 0, sample_rate / torch.clamp_min(lag, 1e-9),
                       torch.zeros_like(lag))


def detect_pitch(x, sample_rate: float, cfft=None, device="cuda") -> dict:
    """All three detectors on one frame, combined on the host: the
    estimates within 3% of their median vote, the pitch is their mean
    and the confidence the share of the three that agree."""
    x = as_tensor(x, device)
    f1 = float(pitch_spectral_peak(x, sample_rate, cfft=cfft))
    f2 = float(harmonic_product_spectrum(x, sample_rate, cfft=cfft))
    f3 = float(pitch_autocorrelation(x, sample_rate, cfft=cfft))
    ests = np.array([f1, f2, f3])
    valid = ests[ests > 0]
    if len(valid) == 0:
        return {"pitch": 0.0, "confidence": 0.0, "estimates": ests.tolist(),
                "note": "?", "cents": 0.0}
    med = float(np.median(valid))
    agree = valid[np.abs(valid - med) < 0.03 * med]
    pitch = float(np.mean(agree)) if len(agree) else med
    name, cents = freq_to_note(pitch)
    return {"pitch": pitch, "confidence": len(agree) / 3.0,
            "estimates": ests.tolist(), "note": name, "cents": cents}
