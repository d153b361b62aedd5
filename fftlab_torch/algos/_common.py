"""Shared helpers of the complex-dtype algorithms (counterpart of
fftlab/algos/_common.py:11-31).

The JAX package embeds its float64 host tables as constants at trace
time; in eager PyTorch a table would cross to the card on every call, so
`table` keeps each one on its device, keyed by the function that builds it
and its arguments, and `const` is left for the small tables built per call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.core.types import Direction, as_complex_array


def prepare(x, direction):
    """Promote to complex, normalize direction, return (x, n, direction)."""
    x = as_complex_array(x)
    return x, int(x.shape[-1]), Direction(int(direction))


def const(arr_np: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host-built float64/complex128 table as a tensor of `like`'s
    dtype on `like`'s device (copied on every call)."""
    a = np.ascontiguousarray(np.asarray(arr_np))
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


@functools.lru_cache(maxsize=64)
def _table(build, args: tuple, dtype: torch.dtype, device: torch.device):
    a = np.ascontiguousarray(build(*args))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def table(build, *args, like: torch.Tensor) -> torch.Tensor:
    """`const(build(*args), like)`, built once per (build, args, dtype,
    device). `build` must be a pure function of `args`."""
    return _table(build, args, like.dtype, like.device)


def table_on(build, *args, dtype: torch.dtype, device) -> torch.Tensor:
    """`build(*args)` as a tensor of `dtype` on `device`, built once per
    (build, args, dtype, device), as `table`; the args must hash."""
    return _table(build, args, dtype, torch.device(device))


@functools.lru_cache(maxsize=64)
def _index_table(build, args: tuple, device: torch.device):
    return torch.from_numpy(np.asarray(build(*args), np.int64)).to(device)


def index_table(build, *args, like: torch.Tensor) -> torch.Tensor:
    """An index table `build(*args)` as an int64 tensor on `like`'s
    device, built once per (build, args, device)."""
    return _index_table(build, args, like.device)


def inverse_scale(x: torch.Tensor, n: int, direction) -> torch.Tensor:
    """Apply the 1/n inverse scaling."""
    if Direction(int(direction)) == Direction.INVERSE:
        return x * (1.0 / n)
    return x


def demo_device(argv: list[str] | None = None) -> torch.device:
    """The `--device` of a module demo (the card by default; `--device cpu`),
    parsed as the `fftlab_torch.cli` demos parse it."""
    import argparse

    from fftlab_torch.cli import parse

    return parse(argparse.ArgumentParser(description="module demo"), argv).device


def run_module_demo(name: str, fn, sizes=(64, 256, 1024), device="cuda") -> None:
    """The demo main of an algorithm module (fftlab/algos/_common.py:33-70),
    `python -m fftlab_torch.algos.<module> [--device cpu]`: for each size
    the JAX demo's three self-checks on complex128 input at atol 1e-8
    (an impulse gives a flat spectrum, DC gives a delta, and the round
    trip returns x), PASS or FAIL, and the microseconds of one forward
    call (`bench.timing.time_ms`: CUDA events on the card). Raises
    SystemExit(1) after the table if any size failed."""
    from fftlab_torch.bench.timing import time_ms
    from fftlab_torch.core.types import require_device

    dev = require_device(device)
    on = lambda a: torch.from_numpy(a).to(dev)
    back = lambda t: t.detach().cpu().numpy()
    print(f"=== {name} demo ({dev.type}) ===")
    failed = []
    for n in sizes:
        imp = np.zeros(n, dtype=np.complex128)
        imp[0] = 1.0
        flat = back(fn(on(imp), Direction.FORWARD))
        ok1 = np.allclose(flat, 1.0, atol=1e-8)
        dc = back(fn(on(np.ones(n, dtype=np.complex128)), Direction.FORWARD))
        ok2 = abs(dc[0] - n) < 1e-8 and np.allclose(dc[1:], 0, atol=1e-7)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        xt = on(x)
        trip = back(fn(fn(xt, Direction.FORWARD), Direction.INVERSE))
        ok3 = np.allclose(trip, x, atol=1e-8)
        us = time_ms(lambda: fn(xt, Direction.FORWARD), dev, iters=5, inner=10) * 1e3
        status = "PASS" if (ok1 and ok2 and ok3) else "FAIL"
        if status == "FAIL":
            failed.append(n)
        print(f"  n={n:<6} impulse/DC/roundtrip {status}   {us:8.1f} us")
    if failed:
        print(f"{name}: FAIL at n = {failed}")
        raise SystemExit(1)
