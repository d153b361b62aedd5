"""Split-radix FFT (counterpart of fftlab/algos/split_radix.py).

An n-point DFT splits into one n/2 DFT of the even samples and two n/4
DFTs of the odd samples x[4j+1], x[4j+3]:

    t1 = W_n^k * O1[k],  t3 = W_n^{3k} * O3[k]      (k < n/4)
    X[k]        = E[k]       + (t1 + t3)
    X[k + n/4]  = E[k + n/4] + i*dir*(t1 - t3)
    X[k + n/2]  = E[k]       - (t1 + t3)
    X[k + 3n/4] = E[k + n/4] - i*dir*(t1 - t3)

The recursion runs down to `leaf`, where the radix-2 kernel takes over.
The JAX package traces the recursion once under `jit`; here every node
runs eagerly, a few launches each, so the call costs grow with n/leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos._common import inverse_scale, prepare, table
from fftlab_torch.algos.radix2 import radix2_dit_unscaled
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two


def _twiddle_np(n: int, direction: int, power: int) -> np.ndarray:
    k = np.arange(n // 4, dtype=np.float64)
    return np.exp(2j * np.pi * float(direction) * power * k / n)


def _rec(x, n: int, direction: Direction, leaf: int):
    if n <= leaf or n < 4:
        return radix2_dit_unscaled(x, direction) if n > 1 else x
    e = _rec(x[..., 0::2], n // 2, direction, leaf)
    o1 = _rec(x[..., 1::4], n // 4, direction, leaf)
    o3 = _rec(x[..., 3::4], n // 4, direction, leaf)
    t1 = o1 * table(_twiddle_np, n, int(direction), 1, like=x)
    t3 = o3 * table(_twiddle_np, n, int(direction), 3, like=x)
    u = t1 + t3
    v = complex(1j * float(int(direction))) * (t1 - t3)
    e_lo = e[..., : n // 4]
    e_hi = e[..., n // 4 :]
    return torch.cat([e_lo + u, e_hi + v, e_lo - u, e_hi - v], dim=-1)


def split_radix_fft(x, direction=FORWARD, leaf: int = 32):
    """Split-radix FFT for power-of-two n; inverse 1/n applied once at
    the top."""
    x, n, direction = prepare(x, direction)
    if not is_power_of_two(n):
        raise ValueError(f"split-radix FFT requires power-of-two size, got n={n}")
    return inverse_scale(_rec(x, n, direction, leaf), n, direction)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("split_radix_fft", split_radix_fft, device=demo_device())
