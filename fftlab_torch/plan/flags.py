"""Planner flags and configuration (counterpart of fftlab/plan/flags.py).

ESTIMATE picks without measuring; MEASURE, PATIENT and EXHAUSTIVE time
the candidates on the device the plan is for and keep the winner as
wisdom (EXHAUSTIVE also times the O(n^2) and educational algorithms);
WISDOM_ONLY takes a measured choice or raises. The other bits keep the
JAX package's values and are not read here.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Flags(enum.IntFlag):
    ESTIMATE = 0
    MEASURE = 1
    PATIENT = 2
    EXHAUSTIVE = 4
    WISDOM_ONLY = 8
    REAL_INPUT = 16
    REAL_OUTPUT = 32
    UNALIGNED = 64
    CONSERVE_MEMORY = 128
    PREFER_DEVICE = 256
    THREADED = 512


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Planner configuration, hashable.

    precision: 'f32' (complex64) or 'f64' (complex128).
    leaf: the largest radix of the Stockham matmul FFT; ESTIMATE sends a
      size with a larger prime factor to Bluestein.
    algorithm: a registry algorithm to force, or None to select.
    The JAX package's `interpret` (a Pallas switch) has no counterpart.
    """

    flags: Flags = Flags.ESTIMATE
    precision: str = "f32"
    leaf: int = 1024
    algorithm: str | None = None

    @property
    def dtype(self) -> torch.dtype:
        return torch.complex128 if self.precision == "f64" else torch.complex64


# The reference's names (fftlab/plan/flags.py:42-48)
FFT_ESTIMATE = Flags.ESTIMATE
FFT_MEASURE = Flags.MEASURE
FFT_PATIENT = Flags.PATIENT
FFT_EXHAUSTIVE = Flags.EXHAUSTIVE
FFT_WISDOM_ONLY = Flags.WISDOM_ONLY
FFT_CONSERVE_MEMORY = Flags.CONSERVE_MEMORY
FFT_PREFER_GPU = Flags.PREFER_DEVICE
