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
