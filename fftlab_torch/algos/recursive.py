"""Educational recursive (out-of-place) radix-2 FFT (counterpart of
fftlab/algos/recursive.py): the textbook even/odd divide and conquer, an
independent implementation in the correctness matrix, not a fast path.
Every node runs eagerly, so n is meant to stay in the thousands.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos._common import inverse_scale, prepare, table
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two


def _half_twiddle_np(n: int, direction: int) -> np.ndarray:
    k = np.arange(n // 2, dtype=np.float64)
    return np.exp(2j * np.pi * float(direction) * k / n)


def _rec(x, n: int, direction: Direction):
    if n == 1:
        return x
    e = _rec(x[..., 0::2], n // 2, direction)
    o = _rec(x[..., 1::2], n // 2, direction)
    t = o * table(_half_twiddle_np, n, int(direction), like=x)
    return torch.cat([e + t, e - t], dim=-1)


def recursive_fft(x, direction=FORWARD):
    """Out-of-place divide-and-conquer FFT (educational; O(n) nodes)."""
    x, n, direction = prepare(x, direction)
    if not is_power_of_two(n):
        raise ValueError(f"recursive FFT requires power-of-two size, got n={n}")
    return inverse_scale(_rec(x, n, direction), n, direction)


def print_recursion_tree(n: int, indent: int = 0) -> None:
    """Print the recursion of an n-point transform."""
    print("  " * indent + f"fft(n={n})")
    if n > 1:
        print_recursion_tree(n // 2, indent + 1)
        print_recursion_tree(n // 2, indent + 1)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("recursive_fft", recursive_fft, device=demo_device())
