"""Algorithm selection and FFT_MEASURE for the complex plans (counterpart
of fftlab/plan/planner.py).

ESTIMATE keeps the JAX package's choice: `naive_dft` for n <= 2, the
Stockham matmul FFT where every prime factor fits the leaf, Bluestein
otherwise. MEASURE, PATIENT and EXHAUSTIVE time every candidate on the
device the plan is for (`bench/timing.py`) and record the winner as
wisdom, with the platform and, on a card, the card's name. A candidate
that raises fails the measurement with its name: no candidate is
skipped and nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from fftlab_torch.algos.mixed_radix import is_highly_composite, is_prime
from fftlab_torch.algos.stockham import max_prime_factor
from fftlab_torch.bench.timing import device_record, measured_here, time_ms
from fftlab_torch.core.types import is_power_of, is_power_of_two, real_dtype_for, require_device
from fftlab_torch.plan import wisdom
from fftlab_torch.plan.flags import Flags, PlanConfig

_MEASURING = Flags.MEASURE | Flags.PATIENT | Flags.EXHAUSTIVE | Flags.WISDOM_ONLY


def estimate_algorithm(n: int, config: PlanConfig) -> str:
    """ESTIMATE-mode selection (no measurement)."""
    if config.algorithm is not None:
        return config.algorithm
    if n <= 2:
        return "naive_dft"
    if max_prime_factor(n) <= config.leaf:
        return "stockham_mxu"
    return "bluestein"


def reference_heuristic(n: int) -> str:
    """The C reference's size classes (fft_auto.c:136-172), for parity
    tests and documentation; not the default."""
    if is_power_of_two(n):
        if n <= 64:
            return "radix2_dit"
        if n <= 1024:
            return "radix4" if is_power_of(n, 4) else "radix2_dit"
        return "split_radix"
    if is_prime(n):
        return "bluestein"
    if is_highly_composite(n):
        return "mixed_radix"
    return "bluestein"


def candidate_algorithms(n: int, flags: Flags, config: PlanConfig) -> list[str]:
    """The candidates MEASURE times: every registry algorithm that takes
    n, the Stockham FFT first; the O(n^2) and educational ones only under
    EXHAUSTIVE."""
    from fftlab_torch.algos import build_registry

    cands = [name for name, spec in build_registry().items() if spec.supports(n)]
    if not flags & Flags.EXHAUSTIVE:
        drop = {"naive_dft", "optimized_dft", "recursive", "iterative"}
        cands = [c for c in cands if c not in drop]
    order = {"stockham_mxu": 0, "radix4": 1, "split_radix": 2, "radix2_dit": 3}
    cands.sort(key=lambda c: order.get(c, 10))
    return cands


def _precision(dtype) -> str:
    return "f64" if dtype == torch.complex128 else "f32"


def _wisdom_choice(n: int, precision: str, device: torch.device) -> str | None:
    """The recorded winner for n, if it names a registry algorithm and was
    measured where `device` is (`measured_here`: the platform and the
    card's name, each where the record has one)."""
    from fftlab_torch.algos import build_registry

    cached = wisdom.lookup(n, precision)
    if cached is None or cached.get("algorithm") not in build_registry():
        return None
    return cached["algorithm"] if measured_here(cached, device) else None


def measure_algorithm(n: int, direction, dtype, flags: Flags, config: PlanConfig,
                      batch: int = 8, iters: int = 5, device="cuda") -> str:
    """Time each candidate on `device` (the card by default) on `batch`
    rows drawn from a torch.Generator seeded with 0; record and return
    the winner. Each candidate's ms is kept in the record
    (`timings_ms`)."""
    from fftlab_torch.algos import build_registry

    dev = require_device(device)
    precision = _precision(dtype)
    cached = _wisdom_choice(n, precision, dev)
    if cached is not None:
        return cached
    if flags & Flags.WISDOM_ONLY:
        raise RuntimeError(f"WISDOM_ONLY set but no wisdom for n={n} ({precision})")
    reg = build_registry()
    gen = torch.Generator(device=dev).manual_seed(0)
    rdtype = real_dtype_for(dtype)
    x = torch.complex(torch.randn(batch, n, generator=gen, device=dev, dtype=rdtype),
                      torch.randn(batch, n, generator=gen, device=dev, dtype=rdtype))
    timings = {}
    for name in candidate_algorithms(n, flags, config):
        fn = functools.partial(reg[name].fn, x, direction)
        try:
            timings[name] = time_ms(fn, dev, iters=iters)
        except Exception as e:
            raise RuntimeError(f"MEASURE n={n}: candidate {name!r} failed on {dev}: "
                               f"{type(e).__name__}: {e}") from e
    best = min(timings, key=timings.get)
    wisdom.record(n, precision, best, timings[best],
                  extra={**device_record(dev), "batch": batch, "timings_ms": timings})
    return best


def select_algorithm(n: int, direction, dtype, config: PlanConfig, device="cuda") -> str:
    """A forced algorithm, else recorded wisdom, else a measurement under
    the measuring flags, else ESTIMATE."""
    if config.algorithm is not None:
        return config.algorithm
    dev = require_device(device) if config.flags & _MEASURING else torch.device(device)
    cached = _wisdom_choice(n, _precision(dtype), dev)
    if cached is not None:
        return cached
    if config.flags & _MEASURING:
        return measure_algorithm(n, direction, dtype, config.flags, config, device=dev)
    return estimate_algorithm(n, config)
