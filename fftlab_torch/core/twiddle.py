"""DFT-matrix and twiddle tables (counterpart of fftlab/core/twiddle.py).

Built on the host in float64 numpy, exactly as the JAX package builds
them, so the float32 tables both packages hand their kernels are equal
bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np

from fftlab_torch.core.types import Direction


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Full n x n DFT matrix F[j,k] = exp(2*pi*i*direction*j*k/n), complex128.

    The phase j*k is reduced mod n in integers before the exponential."""
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n).astype(np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * jk / n)


@functools.lru_cache(maxsize=None)
def stage_twiddle_np(r: int, m: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Cooley-Tukey inter-stage twiddles for n = r*m, shape (r, m):
    T[a, b] = exp(2*pi*i*direction*a*b/(r*m))."""
    n = r * m
    a = np.arange(r, dtype=np.int64)
    b = np.arange(m, dtype=np.int64)
    ab = np.mod(np.outer(a, b), n).astype(np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * ab / n)


@functools.lru_cache(maxsize=None)
def chirp_np(n: int, direction: int = Direction.FORWARD) -> np.ndarray:
    """Bluestein chirp c[k] = exp(pi*i*direction*k^2/n), complex128.

    k^2 is reduced mod 2n in integers before the exponential, which keeps
    the phase exact for large n."""
    k = np.arange(n, dtype=np.int64)
    k2 = np.mod(k * k, 2 * n).astype(np.float64)
    return np.exp(1j * np.pi * float(int(direction)) * k2 / n)
