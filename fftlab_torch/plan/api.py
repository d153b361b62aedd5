"""Split-plane plans (counterpart of fftlab/plan/api.py:38-65 and
:155-212).

A Plan is a frozen route choice and a callable; its `execute` takes and
returns an (re, im) pair of float32 tensors [..., n].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

from fftlab_torch.core.types import FORWARD, Direction
from fftlab_torch.plan.dispatch import run_route, select_split_impl
from fftlab_torch.plan.flags import Flags, PlanConfig


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable transform plan."""

    kind: str  # 'c2c_split'
    n: int
    direction: Direction
    dtype: Any
    algorithm: str  # the route
    config: PlanConfig
    fn: Callable = dataclasses.field(compare=False)

    def execute(self, x):
        return self.fn(x)

    def describe(self) -> str:
        return (f"Plan(kind={self.kind}, n={self.n}, dir={self.direction.name}, "
                f"algorithm={self.algorithm})")


_MEASURING = Flags.MEASURE | Flags.PATIENT | Flags.EXHAUSTIVE | Flags.WISDOM_ONLY


def _split_plan(n: int, direction, route: str, flags: Flags) -> Plan:
    direction = Direction(int(direction))

    def fn(pair):
        xr, xi = pair
        return run_route(route, xr, xi, direction)

    return Plan("c2c_split", n, direction, "float32", route,
                PlanConfig(flags=flags), fn)


def plan_dft_1d_split(n: int, direction=FORWARD,
                      flags: Flags = Flags.ESTIMATE, batch: int = 1) -> Plan:
    """Plan for split re/im float32 planes [..., n]. ESTIMATE picks the
    route from n (`select_split_impl`); FFTLAB_FORCE_IMPL outranks every
    flag. The measuring flags are not ported yet."""
    n = int(n)
    if not os.environ.get("FFTLAB_FORCE_IMPL") and flags & _MEASURING:
        raise NotImplementedError(
            f"flags {Flags(flags)!r}: measured route selection and wisdom "
            "are not ported yet (ROADMAP Queue 1 item 11); use ESTIMATE")
    return _split_plan(n, direction, select_split_impl(n, batch), flags)


# JAX route name -> this package's route; None: the JAX kernel is not
# ported yet, so the route is what select_split_impl picks for n.
_FROM_JAX = {
    "pallas_vmem": "smem_rows",
    "resident_vmem": "two_pass",
    "resident_v4": "two_pass",
    "resident_v6": "two_pass",
    "resident_v4_3x": "two_pass",
    "resident_v6_3x": "two_pass",
    "resident_cio": "two_pass",
    "fourstep_vmem": "two_pass",
    "threestep_vmem": None,
    "pallas_pipeline": None,
    "einsum": "einsum",
}


def plan_from_jax(route: str, n: int, direction: int) -> Plan:
    """This package's plan for a JAX split plan's (route, n, direction),
    read as plain values (`plan.algorithm`, `plan.n`, `int(plan.direction)`)."""
    if route not in _FROM_JAX:
        raise ValueError(f"unknown JAX split route {route!r}")
    n = int(n)
    ours = _FROM_JAX[route] or select_split_impl(n)
    return _split_plan(n, direction, ours, Flags.ESTIMATE)

