"""Bit-reversal permutation table (counterpart of fftlab/core/bitrev.py).

A host-built index table, used by the plan-time float64 FFT
(`core/hostfft.py`); no device code reads it.
"""

from __future__ import annotations

import functools

import numpy as np

from fftlab_torch.core.types import is_power_of_two, log2_int


@functools.lru_cache(maxsize=None)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reverse of i in log2(n) bits (int32)."""
    if not is_power_of_two(n):
        raise ValueError(f"bit_reverse_indices requires power-of-two n, got {n}")
    bits = log2_int(n)
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)
