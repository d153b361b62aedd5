"""Planner flags and configuration (counterpart of fftlab/plan/flags.py).

The split-plane plans of this package honour ESTIMATE only: the route
is picked from n by `plan.dispatch.select_split_impl`. The measuring
flags are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
import enum


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
    """Planner configuration, hashable. The JAX package's precision, leaf,
    algorithm and interpret fields come with the planner they steer
    (ROADMAP Queue 1 item 11)."""

    flags: Flags = Flags.ESTIMATE
