"""Radix-2 Cooley-Tukey, decimation in time and in frequency
(counterpart of fftlab/algos/radix2.py).

The bit reversal is one gather with a host-built index table; each of
the log2(n) stages is a whole-tensor reshape, a broadcast twiddle
multiply and a concat, so every butterfly of a stage runs in one pass.
"""

from __future__ import annotations

import torch

from fftlab_torch.algos._common import index_table, inverse_scale, prepare, table
from fftlab_torch.core.bitrev import bit_reverse_indices
from fftlab_torch.core.twiddle import butterfly_twiddle_np
from fftlab_torch.core.types import FORWARD, INVERSE, is_power_of_two, log2_int


def _check_pow2(n: int):
    if not is_power_of_two(n):
        raise ValueError(f"radix-2 FFT requires power-of-two size, got n={n}")


def radix2_dit_unscaled(x, direction=FORWARD):
    """DIT butterfly passes without the inverse 1/n scale (the leaf of
    split-radix and Bluestein, which scale once at the top)."""
    x, n, direction = prepare(x, direction)
    _check_pow2(n)
    if n == 1:
        return x
    batch = x.shape[:-1]
    x = x.index_select(-1, index_table(bit_reverse_indices, n, like=x))
    for s in range(1, log2_int(n) + 1):
        m = 1 << s
        w = table(butterfly_twiddle_np, m, direction, like=x)  # [m/2]
        x = x.reshape(*batch, n // m, m)
        even = x[..., : m // 2]
        t = x[..., m // 2 :] * w
        x = torch.cat([even + t, even - t], dim=-1)
    return x.reshape(*batch, n)


def radix2_dit(x, direction=FORWARD):
    """Iterative radix-2 DIT: bit-reverse, then log2(n) stages of
    vectorised butterflies."""
    x, n, direction = prepare(x, direction)
    return inverse_scale(radix2_dit_unscaled(x, direction), n, direction)


def radix2_dif(x, direction=FORWARD):
    """Radix-2 DIF: butterflies with the stages descending, the bit
    reversal applied after them."""
    x, n, direction = prepare(x, direction)
    _check_pow2(n)
    if n == 1:
        return x
    batch = x.shape[:-1]
    for s in range(log2_int(n), 0, -1):
        m = 1 << s
        w = table(butterfly_twiddle_np, m, direction, like=x)  # [m/2]
        x = x.reshape(*batch, n // m, m)
        a = x[..., : m // 2]
        b = x[..., m // 2 :]
        x = torch.cat([a + b, (a - b) * w], dim=-1)
    x = x.reshape(*batch, n).index_select(-1, index_table(bit_reverse_indices, n, like=x))
    return inverse_scale(x, n, direction)


def fft_radix2_dit(x):
    """Forward wrapper (fftlab/algos/radix2.py:83)."""
    return radix2_dit(x, FORWARD)


def ifft_radix2_dit(x):
    """Inverse wrapper with 1/n scaling (fftlab/algos/radix2.py:88)."""
    return radix2_dit(x, INVERSE)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("radix2_dit", radix2_dit, device=demo_device())
