"""Plans: the complex-dtype API and the split-plane plans (counterpart of
fftlab/plan/api.py).

A Plan is a frozen choice and a callable, cached per (kind, n, direction,
dtype, config, device type) as FFTW reuses plans. The device type enters
the key because MEASURE times the candidates where the plan is to run:
the card unless the caller passes `device="cpu"` (`fft` and `fft_auto`
pass their tensor's). An ESTIMATE plan runs wherever its tensors are.

Complex kinds: 'c2c' (complex [..., n] in and out), 'r2c' (real [..., n]
in, n//2+1 bins out), 'c2r' (n//2+1 bins in, real [..., n] out, 1/n
scaled), 'c2c_2d' (complex [..., rows, cols]); each runs registry
algorithms (`algos.build_registry`), named in `algorithm` as the JAX
package names them: `radix4`, `rfft[stockham_mxu]`, `stockham_mxuxbluestein`.
A 'c2c_sharded' plan (`plan_dft_1d_sharded`) splits one transform over a
mesh axis of ranks, named `four_step[<axis>=<p>]`.

Split kinds: a 'c2c_split' plan's `execute` takes and returns an (re, im)
pair of float32 tensors [..., n]; an 'r2c_split' plan takes a real
float32 [..., n] and returns the (re, im) pair of its n//2+1 one-sided
bins; a 'c2r_split' plan takes that pair and returns the real [..., n],
1/n scaled. `algorithm` names the route.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable

import torch

from fftlab_torch.core.types import FORWARD, INVERSE, Direction, as_complex_array, torch_dtype
from fftlab_torch.plan.dispatch import run_route, select_split_impl
from fftlab_torch.plan.flags import Flags, PlanConfig
from fftlab_torch.plan.planner import select_algorithm
from fftlab_torch.utils import trace


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable transform plan."""

    kind: str  # 'c2c' | 'r2c' | 'c2r' | 'c2c_2d' | 'c2c_sharded' | 'c2c_split' | 'r2c_split' | 'c2r_split'
    n: Any  # int, or (rows, cols) for 'c2c_2d'
    direction: Direction
    dtype: Any
    algorithm: str  # the algorithm(s), or the route of a split plan
    config: PlanConfig
    fn: Callable = dataclasses.field(compare=False)

    def execute(self, x):
        """Run the plan on `x`: the recorder's root span `execute` while it
        is on (utils/trace.py), opened and closed as near the caller as
        it can be."""
        if not trace.on():
            return self.fn(x)
        rec = trace.begin("execute")
        try:
            return self.fn(x)
        finally:
            trace.end(rec)

    __call__ = execute

    def destroy(self) -> None:
        """A no-op: plans are immutable values."""

    def describe(self) -> str:
        return (f"Plan(kind={self.kind}, n={self.n}, dir={self.direction.name}, "
                f"algorithm={self.algorithm}, dtype={_dtype_name(self.dtype)})")


def _registry():
    from fftlab_torch.algos import build_registry

    return build_registry()


def _inner_n(n: int) -> int:
    """The size of the complex transform inside an r2c/c2r plan: n/2 for
    even n >= 4 (the pack-two-reals path), n otherwise."""
    return n // 2 if (n % 2 == 0 and n >= 4) else max(n, 1)


def _make_plan(kind: str, n, direction: Direction, dtype: torch.dtype,
               config: PlanConfig, algos: tuple) -> Plan:
    """A complex plan running the registry algorithms `algos` (one, or the
    rows' and the columns' for 'c2c_2d')."""
    reg = _registry()
    for a in algos:
        if a not in reg:
            raise KeyError(f"unknown algorithm {a!r}; want one of {tuple(reg)}")
    if kind == "c2c":
        algo = algos[0]
        fn = functools.partial(reg[algo].fn, direction=direction)
    elif kind == "r2c":
        from fftlab_torch.algos.real_fft import rfft

        algo = f"rfft[{algos[0]}]"
        fn = functools.partial(rfft, cfft=reg[algos[0]].fn)
    elif kind == "c2r":
        from fftlab_torch.algos.real_fft import irfft

        algo = f"irfft[{algos[0]}]"
        fn = functools.partial(irfft, n=n, cfft=reg[algos[0]].fn)
    elif kind == "c2c_2d":
        from fftlab_torch.algos.fft2d import fft2

        cols = n[1]
        f_rows, f_cols = reg[algos[0]].fn, reg[algos[1]].fn
        algo = f"{algos[0]}x{algos[1]}"

        def _cfft_2d(x, d):
            # fft2 transforms the last axis twice with a transpose between;
            # the axis length says which pass this is
            return f_cols(x, d) if int(x.shape[-1]) == cols else f_rows(x, d)

        fn = functools.partial(fft2, direction=direction, cfft=_cfft_2d)
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    return Plan(kind, n, direction, dtype, algo, config, fn)


@functools.lru_cache(maxsize=256)
@trace.setup_span("plan")
def _cached_plan(kind: str, n, direction: Direction, dtype_name: str,
                 config: PlanConfig, device: str) -> Plan:
    dtype = getattr(torch, dtype_name)
    select = lambda size, d: select_algorithm(size, d, dtype, config, device)
    if kind == "c2c":
        algos = (select(n, direction),)
    elif kind == "r2c":
        algos = (select(_inner_n(n), FORWARD),)
    elif kind == "c2r":
        algos = (select(_inner_n(n), INVERSE),)
    elif kind == "c2c_2d":
        algos = (select(n[0], direction), select(n[1], direction))
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    return _make_plan(kind, n, direction, dtype, config, algos)


def _plan(kind, n, direction, dtype, config, device) -> Plan:
    return _cached_plan(kind, n, Direction(int(direction)), _dtype_name(dtype), config,
                        torch.device(device).type)


def plan_dft_1d(n: int, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
                dtype=torch.complex64, config: PlanConfig | None = None,
                device="cuda") -> Plan:
    """Complex plan for [..., n]. `dtype` (torch or numpy) names the
    precision the planner looks up and measures; `device` is where
    MEASURE times the candidates."""
    config = config or PlanConfig(flags=flags)
    return _plan("c2c", int(n), direction, torch_dtype(dtype), config, device)


def plan_r2c_1d(n: int, flags: Flags = Flags.ESTIMATE, dtype=torch.float32,
                config: PlanConfig | None = None, device="cuda") -> Plan:
    """Real-to-complex plan: real [..., n] in, n//2+1 bins out."""
    config = config or PlanConfig(flags=flags)
    return _plan("r2c", int(n), FORWARD, torch_dtype(dtype), config, device)


def plan_c2r_1d(n: int, flags: Flags = Flags.ESTIMATE, dtype=torch.complex64,
                config: PlanConfig | None = None, device="cuda") -> Plan:
    """Complex-to-real plan: n//2+1 bins in, real [..., n] out, 1/n scaled."""
    config = config or PlanConfig(flags=flags)
    return _plan("c2r", int(n), INVERSE, torch_dtype(dtype), config, device)


def plan_dft_2d(rows: int, cols: int, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
                dtype=torch.complex64, config: PlanConfig | None = None,
                device="cuda") -> Plan:
    """2-D complex plan for [..., rows, cols]."""
    config = config or PlanConfig(flags=flags)
    return _plan("c2c_2d", (int(rows), int(cols)), direction, torch_dtype(dtype),
                 config, device)


def execute(plan: Plan, x):
    return plan.execute(x)


def fft_auto(x, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
             config: PlanConfig | None = None):
    """One-shot transform: a (cached) plan for x's size, dtype and device,
    executed. A tensor stays on its device; other input goes to the card
    (`core.types.as_complex_array`)."""
    x = as_complex_array(x)
    plan = plan_dft_1d(int(x.shape[-1]), direction, flags, dtype=x.dtype,
                       config=config, device=x.device)
    return plan.execute(x)


def fft(x, direction=FORWARD, algorithm: str | None = None,
        flags: Flags = Flags.ESTIMATE):
    """FFT over the last axis of [..., n]; `algorithm` forces a registry
    algorithm by name, else the planner picks (ESTIMATE: the Stockham
    matmul FFT wherever the prime factors fit its leaf)."""
    return fft_auto(x, direction, flags, PlanConfig(flags=flags, algorithm=algorithm))


def ifft(x, algorithm: str | None = None, flags: Flags = Flags.ESTIMATE):
    """Inverse FFT with 1/n scaling."""
    return fft(x, INVERSE, algorithm, flags)


@trace.setup_span("plan")
def plan_dft_1d_sharded(n: int, mesh, axis_name: str = "tp",
                        direction=FORWARD, n1: int | None = None) -> Plan:
    """A plan whose execution splits ONE transform over `mesh[axis_name]`
    by the four-step decomposition, its transpose an all_to_all between
    the ranks (`dist.four_step.four_step_fft_sharded`; every rank executes
    it on the same whole input and gets the whole spectrum)."""
    from fftlab_torch.dist.four_step import four_step_fft_sharded, split_n

    n = int(n)
    n1_, n2_ = split_n(n, n1)
    p = mesh[axis_name].size()
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both factors "
            f"({n1_}, {n2_}) of n={n}"
        )
    fn = functools.partial(four_step_fft_sharded, mesh=mesh, axis_name=axis_name,
                           direction=direction, n1=n1_)
    return Plan("c2c_sharded", n, Direction(int(direction)), "complex64",
                f"four_step[{axis_name}={p}]", PlanConfig(), fn)


def _split_plan(n: int, direction, route: str, flags: Flags) -> Plan:
    direction = Direction(int(direction))

    def fn(pair):
        xr, xi = pair
        return run_route(route, xr, xi, direction)

    return Plan("c2c_split", n, direction, "float32", route,
                PlanConfig(flags=flags), fn)


def _split_route_for(n: int, flags: Flags, batch: int, device) -> str:
    """The route of an n-point split transform: FFTLAB_FORCE_IMPL outranks
    every flag; MEASURE, PATIENT and EXHAUSTIVE take the recorded route or
    time the routes on `device` and record the winner
    (`split_tuning.tune_split_route`); WISDOM_ONLY takes the recorded
    route or raises; ESTIMATE picks from n (`select_split_impl`)."""
    from fftlab_torch.plan.split_tuning import best_route, tune_split_route

    if os.environ.get("FFTLAB_FORCE_IMPL"):
        return select_split_impl(n, batch)  # validates and returns the forced route
    if flags & (Flags.MEASURE | Flags.PATIENT | Flags.EXHAUSTIVE):
        return best_route(n, device) or tune_split_route(n, batch=batch, device=device)
    if flags & Flags.WISDOM_ONLY:
        route = best_route(n, device)
        if route is None:
            raise RuntimeError(f"WISDOM_ONLY set but no measured route wisdom for n={n}")
        return route
    return select_split_impl(n, batch)


@trace.setup_span("plan")
def plan_dft_1d_split(n: int, direction=FORWARD, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1, device="cuda") -> Plan:
    """Plan for split re/im float32 planes [..., n]. ESTIMATE picks the
    route from n (`select_split_impl`); the measuring flags time the
    routes for (n, batch) on `device` (the card by default) and keep the
    winner as wisdom; FFTLAB_FORCE_IMPL outranks every flag."""
    n = int(n)
    return _split_plan(n, direction, _split_route_for(n, flags, batch, device), flags)


# The route of the fused r2c/c2r kernels (kernels/rfft_resident.py).
_RESIDENT = "resident"


def _split_route_for_half(n: int, flags: Flags, batch: int, device) -> str:
    """The route of the HALF-size transform inside an r2c/c2r plan, with
    errors naming the half size: a bare 'no wisdom for n//2' would send
    the caller to measure the full n, which cannot help."""
    try:
        return _split_route_for(n // 2, flags, batch, device)
    except RuntimeError as e:
        raise RuntimeError(
            f"{e} (the r2c/c2r plan for n={n} runs a half-size complex "
            f"transform: measure n={n // 2}, e.g. "
            f"plan_dft_1d_split({n // 2}, flags=Flags.MEASURE))") from None


def _real_route(n: int, flags: Flags, batch: int, device) -> str:
    """The route of an n-point r2c/c2r plan, in the JAX package's order:
    'einsum' for odd n or n < 4 (rfft_split's complex fallback), the fused
    kernels where n/2 is in their window (unless FFTLAB_RFFT_FUSED=0),
    else the half-size route under the flags."""
    from fftlab_torch.algos.split_stockham import _fused_enabled
    from fftlab_torch.kernels.rfft_resident import supported_rfft_resident

    if n % 2 or n < 4:
        return "einsum"
    if supported_rfft_resident(n) and _fused_enabled():
        return _RESIDENT
    return _split_route_for_half(n, flags, batch, device)


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


@trace.setup_span("plan")
def plan_r2c_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1, device="cuda") -> Plan:
    """Real-to-complex plan: real float32 [..., n] in, the (re, im) pair
    of its n//2+1 one-sided bins out. `algorithm` names the route, as in
    the JAX package: `rfft_resident` (the fused kernels, n/2 pow2 in
    2^15..2^20) or `rfft_split[<route of the n/2-point c2c>]`."""
    n = int(n)
    return _real_plan("r2c_split", n, _real_route(n, flags, batch, device), flags)


@trace.setup_span("plan")
def plan_c2r_1d_split(n: int, flags: Flags = Flags.ESTIMATE,
                      batch: int = 1, device="cuda") -> Plan:
    """Complex-to-real plan, the inverse of `plan_r2c_1d_split`: the
    (re, im) pair of n//2+1 bins in, real [..., n] out, 1/n scaled.
    `algorithm` is `irfft_resident` or `irfft_split[<route>]`."""
    n = int(n)
    return _real_plan("c2r_split", n, _real_route(n, flags, batch, device), flags)


@trace.setup_span("plan")
def plan_dft_1d_native(n: int, direction=FORWARD) -> Plan:
    """A plan on the host's native float64 FFT (native/fft64.cpp through
    `fftlab_torch.native.fft64`): complex128 numpy [..., n] in and out (a
    tensor is read on the host), the direction honoured, the inverse 1/n
    scaled; no card. Raises ValueError for non-pow2 n, and RuntimeError
    at plan time if the native library cannot be built."""
    from fftlab_torch.core.types import is_power_of_two
    from fftlab_torch.native.fft64 import fft64
    from fftlab_torch.native.lib import load_native_lib

    n = int(n)
    if not is_power_of_two(n):
        raise ValueError(f"native backend supports pow2 n; got {n}")
    load_native_lib()  # fail at plan time, not at execute time
    direction = Direction(int(direction))
    inv = direction == INVERSE

    def fn(x):
        if int(x.shape[-1]) != n:
            raise ValueError(f"plan is for n={n}; got {x.shape[-1]}")
        return fft64(x, inverse=inv)

    return Plan("c2c_native", n, direction, "complex128", "native_fft64", PlanConfig(), fn)


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


def _complex_from_jax(algorithm: str, n, direction, kind: str) -> Plan:
    """The complex plan running the registry algorithms a JAX plan names:
    `radix4` (c2c), `rfft[<algo>]` (r2c), `irfft[<algo>]` (c2r),
    `<rows' algo>x<cols' algo>` (c2c_2d)."""
    reg = _registry()
    if kind == "c2c":
        algos = (algorithm,)
    elif kind in ("r2c", "c2r"):
        prefix = "rfft[" if kind == "r2c" else "irfft["
        if not (algorithm.startswith(prefix) and algorithm.endswith("]")):
            raise ValueError(f"unknown JAX {kind} algorithm {algorithm!r}")
        algos = (algorithm[len(prefix):-1],)
    else:  # c2c_2d: registry names contain 'x' too, so try every split
        algos = next(((algorithm[:i], algorithm[i + 1:])
                      for i, c in enumerate(algorithm)
                      if c == "x" and algorithm[:i] in reg and algorithm[i + 1:] in reg),
                     None)
        if algos is None:
            raise ValueError(f"unknown JAX c2c_2d algorithm {algorithm!r}")
    if any(a not in reg for a in algos):
        raise ValueError(f"unknown JAX {kind} algorithm {algorithm!r}")
    if kind == "c2c_2d":
        n = tuple(int(v) for v in n)
    else:
        n = int(n)
    direction = {"r2c": FORWARD, "c2r": INVERSE}.get(kind, Direction(int(direction)))
    dtype = torch.float32 if kind == "r2c" else torch.complex64
    return _make_plan(kind, n, direction, dtype,
                      PlanConfig(algorithm=algos[0] if len(algos) == 1 else None), algos)


@trace.setup_span("plan")
def plan_from_jax(route: str, n, direction: int = FORWARD,
                  kind: str = "c2c_split") -> Plan:
    """This package's plan for a JAX plan, read as plain values:
    `plan.algorithm`, `plan.n`, `int(plan.direction)` and `plan.kind`.
    A split c2c route maps by name; a split r2c/c2r algorithm
    (`rfft_resident`, `irfft_resident`, `rfft_split[<route>]`,
    `irfft_split[<route>]`) maps to the same form with its half-size
    route mapped by name. A complex plan ('c2c', 'r2c', 'c2r', 'c2c_2d')
    runs the registry algorithms it names. The direction of an r2c/c2r
    plan is its kind's."""
    if kind in ("c2c", "r2c", "c2r", "c2c_2d"):
        return _complex_from_jax(route, n, direction, kind)
    n = int(n)
    if kind == "c2c_split":
        if route not in _FROM_JAX:
            raise ValueError(f"unknown JAX split route {route!r}")
        return _split_plan(n, direction, _FROM_JAX[route], Flags.ESTIMATE)
    names = {"r2c_split": "rfft", "c2r_split": "irfft"}
    if kind not in names:
        raise ValueError(f"unknown JAX plan kind {kind!r}; want one of "
                         f"{('c2c', 'r2c', 'c2r', 'c2c_2d', 'c2c_split', *names)}")
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

