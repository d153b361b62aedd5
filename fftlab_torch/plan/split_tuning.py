"""FFT_MEASURE for the split-plane plans (counterpart of
fftlab/plan/split_tuning.py): the route of a split FFT, and the leaf of
the einsum route, timed on the device the plan is for.

The routes are the port's, gated by the predicates `select_split_impl`
uses (plan/dispatch.py): `einsum` always; on a card `smem_rows` where
`supported_size(n)` holds (1K-16K, below the static rule's 8K floor
too), `two_pass` for 2^15..2^21 and `three_pass` for 2^21..2^26 (at
2^21 beside two passes, which the static rule keeps there), as the JAX
tuner times every route whose window holds n. The
stage pipeline is not a candidate, as the JAX tuner never times its
stage kernel either. Off a card `einsum` is the only candidate, as the
JAX package has only `einsum` off a TPU. Each route runs through
`dispatch.run_route` on the same input, back to back (`bench/timing.py`):
the JAX tuner feeds each output back as the next input, scaled by
1/sqrt(n), only because its TPU service memoises repeated calls. A
route that raises fails the measurement with its name. Winners persist
through plan/wisdom.py under kind 'route' and 'split'.
"""

from __future__ import annotations

import os
import warnings

import torch

from fftlab_torch.bench.timing import device_record, measured_here, time_ms
from fftlab_torch.core.types import FORWARD, require_device
from fftlab_torch.plan import wisdom

DEFAULT_LEAVES = (64, 128, 256, 512)


def _planes(batch: int, n: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(batch, n, generator=gen, device=device),
            torch.randn(batch, n, generator=gen, device=device))


def _measure(what: str, fn, device: torch.device, iters: int) -> float:
    try:
        return time_ms(fn, device, iters=iters)
    except Exception as e:
        raise RuntimeError(f"split MEASURE: {what} failed on {device}: "
                           f"{type(e).__name__}: {e}") from e


def tune_split_leaf(n: int, leaves=DEFAULT_LEAVES, batch: int = 4, iters: int = 6,
                    persist: bool = True, device="cuda") -> int:
    """Time the einsum route's leaf candidates for an n-point split FFT on
    `device`; record and return the winner. A leaf below n's largest
    prime factor cannot run and is not timed; with none left, the
    default leaf."""
    from fftlab_torch.algos.split_stockham import DEFAULT_LEAF_SPLIT, fft_split
    from fftlab_torch.algos.stockham import max_prime_factor

    dev = require_device(device)
    xr, xi = _planes(batch, n, dev)
    timings = {leaf: _measure(f"leaf {leaf}", lambda leaf=leaf: fft_split(xr, xi, leaf=leaf),
                              dev, iters)
               for leaf in leaves if max_prime_factor(n) <= leaf}
    if not timings:
        return DEFAULT_LEAF_SPLIT
    best = min(timings, key=timings.get)
    if persist:
        wisdom.record(n, "f32", f"leaf={best}", timings[best], kind="split",
                      extra=device_record(dev))
    return best


def best_leaf(n: int, device="cuda") -> int:
    """The leaf recorded for n where `device` is (`measured_here`), or the
    default: the leaf the einsum route runs (`dispatch.run_route`)."""
    from fftlab_torch.algos.split_stockham import DEFAULT_LEAF_SPLIT

    cached = wisdom.lookup(n, "f32", kind="split")
    if cached and cached["algorithm"].startswith("leaf=") and measured_here(cached, device):
        return int(cached["algorithm"].split("=", 1)[1])
    return DEFAULT_LEAF_SPLIT


def _route_candidates(n: int, device="cuda") -> list[str]:
    """The routes measurable for an n-point split FFT on `device`."""
    cands = ["einsum"]
    if torch.device(device).type != "cuda":
        return cands
    from fftlab_torch.kernels.fft_vmem import supported_size
    from fftlab_torch.kernels.fourstep_vmem import supported_large
    from fftlab_torch.kernels.threestep_vmem import supported_huge

    if supported_size(n):
        cands.append("smem_rows")
    if supported_large(n):
        cands.append("two_pass")
    if supported_huge(n):
        cands.append("three_pass")
    return cands


def tune_split_route(n: int, batch: int = 4, persist: bool = True, *, iters: int = 5,
                     device="cuda") -> str:
    """Time every route for (n, batch) on `device` (the card by default)
    and return the winner; with `persist`, record it under kind 'route'
    with every route's ms (`timings_ms`) and merge it into the wisdom file,
    so a later process skips the measurement. `iters` and `device` are
    keyword-only: the JAX function's 4th and 5th parameters are its
    chain lengths and repeats."""
    from fftlab_torch.plan.dispatch import run_route

    dev = require_device(device)
    xr, xi = _planes(batch, n, dev)
    timings = {route: _measure(f"route {route!r} at n={n}",
                               lambda route=route: run_route(route, xr, xi, FORWARD),
                               dev, iters)
               for route in _route_candidates(n, dev)}
    best = min(timings, key=timings.get)
    if persist:
        wisdom.record(n, "f32", best, timings[best], kind="route",
                      extra={**device_record(dev), "batch": batch, "timings_ms": timings})
        try:  # merge the file's other sizes first, then write it back
            wisdom.import_wisdom(overwrite=False)
            wisdom.export_wisdom()
        except (OSError, ValueError) as e:
            warnings.warn(f"route wisdom for n={n} kept in this process only: "
                          f"the wisdom file could not be read or written ({e})")
    return best


_WISDOM_FILE_LOADED = False


def _ensure_wisdom_loaded() -> None:
    """Load the wisdom file once per process, so routes an earlier process
    measured serve this one; entries measured in this process win.
    FFTLAB_NO_WISDOM_FILE=1 opts out. A file that cannot be read is
    ignored, as in the JAX package."""
    global _WISDOM_FILE_LOADED
    if _WISDOM_FILE_LOADED:
        return
    _WISDOM_FILE_LOADED = True
    if os.environ.get("FFTLAB_NO_WISDOM_FILE"):
        return
    try:
        wisdom.import_wisdom(overwrite=False)
    except (OSError, ValueError):
        pass


def best_route(n: int, device="cuda") -> str | None:
    """The wisdom-recorded route for n: None if never measured, measured
    elsewhere (`measured_here`: another platform or another card, since
    wisdom files travel by export and import), or not a candidate on
    `device`. The record is keyed by n alone: the batch it was measured
    at is kept in it and not compared, as in the JAX package. A
    reduced-precision `_3x` route never becomes the default: its
    full-precision route is taken instead."""
    _ensure_wisdom_loaded()
    cached = wisdom.lookup(n, "f32", kind="route")
    if not cached or not measured_here(cached, device):
        return None
    route = cached.get("algorithm")
    if route is not None and route.endswith("_3x"):
        route = route[:-3]
    return route if route in _route_candidates(n, device) else None
