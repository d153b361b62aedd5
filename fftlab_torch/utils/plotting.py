"""ASCII spectrum plots, the demos' terminal display (the port's own copy
of fftlab/utils/plotting.py, which it may not import: importing any
`fftlab` module imports JAX).

Numpy only: the demos read a tensor back to the host before they plot it.
tests/test_torch_dsp_apps.py holds every function equal to the original.
"""

from __future__ import annotations

import numpy as np

_RAMP = " .:-=+*#%@"


def ascii_spectrum(mag, n_bins: int = 32, width: int = 50,
                   freqs=None, db: bool = False) -> str:
    """Horizontal bar chart of a magnitude spectrum
    (fft_utils.c:190-219)."""
    m = np.asarray(mag, dtype=np.float64)
    if m.ndim != 1:
        raise ValueError("ascii_spectrum expects a 1D magnitude array")
    n_bins = min(n_bins, len(m))
    # Aggregate into n_bins groups (max within group, like a peak-hold).
    edges = np.linspace(0, len(m), n_bins + 1).astype(int)
    vals = np.array([m[a:b].max() if b > a else 0.0
                     for a, b in zip(edges[:-1], edges[1:])])
    if db:
        vals = 20 * np.log10(np.maximum(vals, 1e-12))
        lo, hi = vals.min(), vals.max()
    else:
        lo, hi = 0.0, max(vals.max(), 1e-12)
    span = max(hi - lo, 1e-12)
    lines = []
    for i, v in enumerate(vals):
        bar = "#" * int(round((v - lo) / span * width))
        if freqs is not None:
            f = np.asarray(freqs)[edges[i]]
            label = f"{f:9.1f} "
        else:
            label = f"{edges[i]:5d} "
        lines.append(f"{label}|{bar}")
    return "\n".join(lines)


def ascii_image(img, width: int = 64, height: int = 32) -> str:
    """2D array as a character-ramp image (image_fft.c:181-211)."""
    a = np.asarray(img, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError("ascii_image expects a 2D array")
    ys = np.linspace(0, a.shape[0] - 1, min(height, a.shape[0])).astype(int)
    xs = np.linspace(0, a.shape[1] - 1, min(width, a.shape[1])).astype(int)
    sub = a[np.ix_(ys, xs)]
    lo, hi = sub.min(), sub.max()
    span = max(hi - lo, 1e-12)
    idx = ((sub - lo) / span * (len(_RAMP) - 1)).astype(int)
    return "\n".join("".join(_RAMP[v] for v in row) for row in idx)


def ansi_clear() -> str:
    """ANSI home+clear prefix for live displays
    (realtime_analyzer.c:104-110)."""
    return "\033[2J\033[H"
