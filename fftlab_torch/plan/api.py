"""Split-plane plans (counterpart of fftlab/plan/api.py:38-65 and
:155-307).

A Plan is a frozen route choice and a callable. A c2c plan's `execute`
takes and returns an (re, im) pair of float32 tensors [..., n]; an r2c
plan takes a real float32 [..., n] and returns the (re, im) pair of its
n//2+1 one-sided bins; a c2r plan takes that pair and returns the real
[..., n], 1/n scaled.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

from fftlab_torch.core.types import FORWARD, INVERSE, Direction
from fftlab_torch.plan.dispatch import run_route, select_split_impl
from fftlab_torch.plan.flags import Flags, PlanConfig


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable transform plan."""

    kind: str  # 'c2c_split' | 'r2c_split' | 'c2r_split'
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


def _split_route_for(n: int, flags: Flags, batch: int) -> str:
    """The route of an n-point split transform: FFTLAB_FORCE_IMPL outranks
    every flag, ESTIMATE picks from n (`select_split_impl`), and the
    measuring flags are not ported yet."""
    if not os.environ.get("FFTLAB_FORCE_IMPL") and flags & _MEASURING:
        raise NotImplementedError(
            f"flags {Flags(flags)!r}: measured route selection and wisdom "
            "are not ported yet (ROADMAP Queue 1 item 11); use ESTIMATE")
    return select_split_impl(n, batch)


def plan_dft_1d_split(n: int, direction=FORWARD,
                      flags: Flags = Flags.ESTIMATE, batch: int = 1) -> Plan:
    """Plan for split re/im float32 planes [..., n]. ESTIMATE picks the
    route from n (`select_split_impl`); FFTLAB_FORCE_IMPL outranks every
    flag. The measuring flags are not ported yet."""
    n = int(n)
    return _split_plan(n, direction, _split_route_for(n, flags, batch), flags)


# The route of the fused r2c/c2r kernels (kernels/rfft_resident.py).
_RESIDENT = "resident"


def _split_route_for_half(n: int, flags: Flags, batch: int) -> str:
    """The route of the HALF-size transform inside an r2c/c2r plan, with
    errors naming the half size."""
    try:
        return _split_route_for(n // 2, flags, batch)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"{e} (the r2c/c2r plan for n={n} runs a half-size complex "
            f"transform of n/2 = {n // 2})") from None


def _real_route(n: int, flags: Flags, batch: int) -> str:
    """The route of an n-point r2c/c2r plan: 'einsum' for odd n or n < 4
    (rfft_split's complex fallback), the fused kernels where n/2 is in
    their window (unless FFTLAB_RFFT_FUSED=0), else the half-size route."""
    from fftlab_torch.algos.split_stockham import _fused_enabled
    from fftlab_torch.kernels.rfft_resident import supported_rfft_resident

    route = _split_route_for_half(n, flags, batch)  # checks the flags
    if n % 2 or n < 4:
        return "einsum"
    if supported_rfft_resident(n) and _fused_enabled():
        return _RESIDENT
    return route


def _real_plan(kind: str, n: int, route: str, flags: Flags) -> Plan:
    """An r2c or c2r plan over `route`: the fused kernels or
    rfft_split/irfft_split with the half-size transform on that route."""
    from fftlab_torch.algos.split_stockham import irfft_split, rfft_split
    from fftlab_torch.kernels.rfft_resident import irfft_resident, rfft_resident

    if kind == "r2c_split":
        direction, name = FORWARD, "rfft"
        if route == _RESIDENT:
            fn = rfft_resident
        elif n % 2 or n < 4:
            fn = rfft_split
        else:
            cfft = lambda a, b: run_route(route, a, b, FORWARD)
            fn = lambda x: rfft_split(x, cfft=cfft)
    else:
        direction, name = INVERSE, "irfft"
        if route == _RESIDENT:
            fn = lambda pair: irfft_resident(*pair)
        elif n % 2 or n < 4:
            fn = lambda pair: irfft_split(*pair, n=n)
        else:
            cfft = lambda a, b: run_route(route, a, b, INVERSE)
            fn = lambda pair: irfft_split(*pair, n=n, cfft=cfft)
    algorithm = (f"{name}_resident" if route == _RESIDENT
                 else f"{name}_split[{route}]")
    return Plan(kind, n, direction, "float32", algorithm, PlanConfig(flags=flags), fn)


def plan_r2c_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1) -> Plan:
    """Real-to-complex plan: real float32 [..., n] in, the (re, im) pair
    of its n//2+1 one-sided bins out. `algorithm` names the route, as in
    the JAX package: `rfft_resident` (the fused kernels, n/2 pow2 in
    2^15..2^20) or `rfft_split[<route of the n/2-point c2c>]`."""
    n = int(n)
    return _real_plan("r2c_split", n, _real_route(n, flags, batch), flags)


def plan_c2r_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1) -> Plan:
    """Complex-to-real plan, the inverse of `plan_r2c_1d_split`: the
    (re, im) pair of n//2+1 bins in, real [..., n] out, 1/n scaled.
    `algorithm` is `irfft_resident` or `irfft_split[<route>]`."""
    n = int(n)
    return _real_plan("c2r_split", n, _real_route(n, flags, batch), flags)


# JAX route name -> this package's route.
_FROM_JAX = {
    "pallas_vmem": "smem_rows",
    "resident_vmem": "two_pass",
    "resident_v4": "two_pass",
    "resident_v6": "two_pass",
    "resident_v4_3x": "two_pass",
    "resident_v6_3x": "two_pass",
    "resident_cio": "two_pass",
    "fourstep_vmem": "two_pass",
    "threestep_vmem": "three_pass",
    "pallas_pipeline": "stage_pipeline",
    "einsum": "einsum",
}


def plan_from_jax(route: str, n: int, direction: int = FORWARD,
                  kind: str = "c2c_split") -> Plan:
    """This package's plan for a JAX split plan, read as plain values:
    `plan.algorithm`, `plan.n`, `int(plan.direction)` and `plan.kind`.
    A c2c route maps by name; an r2c/c2r algorithm (`rfft_resident`,
    `irfft_resident`, `rfft_split[<route>]`, `irfft_split[<route>]`) maps
    to the same form with its half-size route mapped by name; the
    direction of an r2c/c2r plan is its kind's."""
    n = int(n)
    if kind == "c2c_split":
        if route not in _FROM_JAX:
            raise ValueError(f"unknown JAX split route {route!r}")
        return _split_plan(n, direction, _FROM_JAX[route], Flags.ESTIMATE)
    names = {"r2c_split": "rfft", "c2r_split": "irfft"}
    if kind not in names:
        raise ValueError(f"unknown JAX plan kind {kind!r}; want one of "
                         f"{('c2c_split', *names)}")
    name = names[kind]
    if route == f"{name}_resident":
        from fftlab_torch.kernels.rfft_resident import supported_rfft_resident

        if not supported_rfft_resident(n):
            raise ValueError(f"{route} takes n/2 pow2 in [2^15, 2^20]; got n={n}")
        return _real_plan(kind, n, _RESIDENT, Flags.ESTIMATE)
    prefix = f"{name}_split["
    inner = route[len(prefix):-1] if route.startswith(prefix) and route.endswith("]") else None
    if inner not in _FROM_JAX:
        raise ValueError(f"unknown JAX {kind} algorithm {route!r}")
    return _real_plan(kind, n, _FROM_JAX[inner], Flags.ESTIMATE)

