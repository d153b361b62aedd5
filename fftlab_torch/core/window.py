"""Window functions (counterpart of fftlab/core/window.py).

Plan-time constants, computed in float64 numpy with the JAX package's
code and converted to the working dtype where they are used.
`periodic=True` (the DFT-analysis convention) divides by n, not n-1.
"""

from __future__ import annotations

import functools

import numpy as np


def _grid(n: int, periodic: bool) -> np.ndarray:
    denom = n if periodic else max(n - 1, 1)
    return np.arange(n, dtype=np.float64) / denom


@functools.lru_cache(maxsize=None)
def rectangular(n: int, periodic: bool = True) -> np.ndarray:
    return np.ones(n, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def hann(n: int, periodic: bool = True) -> np.ndarray:
    """0.5*(1-cos(2*pi*t))."""
    return 0.5 * (1.0 - np.cos(2 * np.pi * _grid(n, periodic)))


@functools.lru_cache(maxsize=None)
def hamming(n: int, periodic: bool = True) -> np.ndarray:
    """0.54 - 0.46*cos(2*pi*t)."""
    return 0.54 - 0.46 * np.cos(2 * np.pi * _grid(n, periodic))


@functools.lru_cache(maxsize=None)
def blackman(n: int, periodic: bool = True) -> np.ndarray:
    """0.42 - 0.5*cos(2*pi*t) + 0.08*cos(4*pi*t)."""
    t = _grid(n, periodic)
    return 0.42 - 0.5 * np.cos(2 * np.pi * t) + 0.08 * np.cos(4 * np.pi * t)


@functools.lru_cache(maxsize=None)
def kaiser(n: int, beta: float = 8.6, periodic: bool = True) -> np.ndarray:
    """Kaiser window I0(beta*sqrt(1-(2t-1)^2))/I0(beta)."""
    t = 2.0 * _grid(n, periodic) - 1.0
    return np.i0(beta * np.sqrt(np.clip(1.0 - t * t, 0.0, 1.0))) / np.i0(beta)


@functools.lru_cache(maxsize=None)
def tukey(n: int, alpha: float = 0.5, periodic: bool = True) -> np.ndarray:
    """Tapered-cosine window."""
    if alpha <= 0:
        return rectangular(n, periodic)
    if alpha >= 1:
        return hann(n, periodic)
    t = _grid(n, periodic)
    w = np.ones(n, dtype=np.float64)
    lo = t < alpha / 2
    hi = t >= 1 - alpha / 2
    w[lo] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[lo] - alpha / 2)))
    w[hi] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[hi] - 1 + alpha / 2)))
    return w


WINDOWS = {
    "rectangular": rectangular,
    "boxcar": rectangular,
    "hann": hann,
    "hanning": hann,
    "hamming": hamming,
    "blackman": blackman,
    "kaiser": kaiser,
    "tukey": tukey,
}


def get_window(name_or_array, n: int, periodic: bool = True, **kwargs) -> np.ndarray:
    """Resolve a window by name (or pass an array through, length-checked).
    A named window is a copy, so a caller's in-place edit cannot reach the
    cached one."""
    if isinstance(name_or_array, str):
        try:
            fn = WINDOWS[name_or_array.lower()]
        except KeyError:
            raise ValueError(
                f"unknown window {name_or_array!r}; known: {sorted(set(WINDOWS))}"
            ) from None
        return fn(n, periodic=periodic, **kwargs).copy()
    w = np.asarray(name_or_array, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"window has shape {w.shape}, expected ({n},)")
    return w


def coherent_gain(w: np.ndarray) -> float:
    """sum(w)/n: the amplitude correction factor."""
    return float(np.sum(w) / len(w))


def power_gain(w: np.ndarray) -> float:
    """sum(w^2)/n: the power (PSD) correction factor."""
    return float(np.sum(w * w) / len(w))
