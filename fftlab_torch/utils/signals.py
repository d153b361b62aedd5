"""Test-signal generators (the port's own copy of fftlab/utils/signals.py,
which it may not import: importing any `fftlab` module imports JAX).

Host-side numpy (float64) by design: signals are test and demo inputs,
not device compute. tests/test_torch_dsp_apps.py holds every generator
equal to the original.
"""

from __future__ import annotations

import numpy as np


def _t(n: int, sample_rate: float) -> np.ndarray:
    return np.arange(n, dtype=np.float64) / sample_rate


def generate_sine(n: int, freq: float, sample_rate: float = None,
                  amplitude: float = 1.0, phase: float = 0.0) -> np.ndarray:
    """sin(2*pi*f*t) (fft_common.h:148-152). If sample_rate is None, `freq`
    is in cycles-per-window (bin units), matching the reference demos."""
    sr = sample_rate if sample_rate is not None else float(n)
    return amplitude * np.sin(2 * np.pi * freq * _t(n, sr) + phase)


def generate_cosine(n: int, freq: float, sample_rate: float = None,
                    amplitude: float = 1.0) -> np.ndarray:
    sr = sample_rate if sample_rate is not None else float(n)
    return amplitude * np.cos(2 * np.pi * freq * _t(n, sr))


def generate_square(n: int, freq: float, sample_rate: float = None,
                    amplitude: float = 1.0) -> np.ndarray:
    """Square wave via sign of sine (fft_common.h:154-158)."""
    return amplitude * np.sign(generate_sine(n, freq, sample_rate) + 1e-300)


def generate_impulse(n: int, position: int = 0) -> np.ndarray:
    """Unit impulse (fft_common.h:160-164)."""
    x = np.zeros(n, dtype=np.float64)
    x[position] = 1.0
    return x


def generate_dc(n: int, level: float = 1.0) -> np.ndarray:
    return np.full(n, level, dtype=np.float64)


def generate_chirp(n: int, f0: float, f1: float, sample_rate: float = None,
                   amplitude: float = 1.0) -> np.ndarray:
    """Linear chirp f0 -> f1 (fft_utils.c:17-25)."""
    sr = sample_rate if sample_rate is not None else float(n)
    t = _t(n, sr)
    duration = n / sr
    k = (f1 - f0) / duration
    return amplitude * np.sin(2 * np.pi * (f0 * t + 0.5 * k * t * t))


def generate_noise(n: int, amplitude: float = 1.0, seed: int = 42) -> np.ndarray:
    """Seeded uniform noise in [-a, a] (fft_utils.c:27-35)."""
    rng = np.random.default_rng(seed)
    return amplitude * (2.0 * rng.random(n) - 1.0)


def generate_multi_tone(n: int, freqs, amps=None, sample_rate: float = None) -> np.ndarray:
    """Sum of sines (fft_utils.c:37-46)."""
    freqs = list(freqs)
    if amps is None:
        amps = [1.0] * len(freqs)
    out = np.zeros(n, dtype=np.float64)
    for f, a in zip(freqs, amps):
        out += generate_sine(n, f, sample_rate, a)
    return out


def generate_complex_noise(n: int, seed: int = 42, batch=()) -> np.ndarray:
    """Complex gaussian noise for FFT tests (complex128)."""
    rng = np.random.default_rng(seed)
    shape = tuple(batch) + (n,)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def zero_pad(x, total: int) -> np.ndarray:
    """Zero-pad a 1D signal to `total` samples (fft_utils.c:239-247)."""
    x = np.asarray(x)
    if total < x.shape[-1]:
        raise ValueError(f"cannot pad {x.shape[-1]} samples down to {total}")
    pad = [(0, 0)] * (x.ndim - 1) + [(0, total - x.shape[-1])]
    return np.pad(x, pad)


def frequency_shift(x, shift_hz: float, sample_rate: float) -> np.ndarray:
    """Modulate by exp(2*pi*i*f0*t) — spectrum shift (fft_utils.c:250-255)."""
    x = np.asarray(x)
    n = x.shape[-1]
    t = np.arange(n, dtype=np.float64) / sample_rate
    return x * np.exp(2j * np.pi * shift_hz * t)
