"""Self-sorting mixed-radix FFT where every stage is a batched matmul
(counterpart of fftlab/algos/stockham.py), and the radix planning that
the split-plane Stockham shares.

Any n whose prime factors are at most `leaf` is taken, as in the JAX
package; the stages' radices are capped lower (`STAGE_RADIX`) for
accuracy, at 32 x 32 x 32 x 32 for 2^20 where the JAX package runs
1024 x 1024. Each stage contracts one digit axis with the radix's DFT matrix, one
complex matmul (CGEMM on the card for complex64, at full float32:
`core/precision.py full_float32`), then applies the inter-stage
twiddles as one multiply; the digit reversal is a single final
transpose. Tables are float64-built and cached per (n, direction,
dtype, device).
"""

from __future__ import annotations

import functools
import string

import torch

from fftlab_torch.algos._common import inverse_scale, prepare, table
from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import FORWARD, is_power_of_two

DEFAULT_LEAF = 1024

# The largest radix a stage contracts in one matmul, unless a prime
# factor needs more. A float32 sum of K products loses about
# 2^-24 * sqrt(K/6) of its size: at the JAX package's leaf of 1024 (one
# MXU pass) cuBLAS's CGEMM leaves complex64 16 x 2^20 under the 120 dB
# c2c gate on an H100, and smaller radices are both more accurate and
# faster there (scripts/torch_stockham_radix.py; PERF.md).
STAGE_RADIX = 64


@functools.lru_cache(maxsize=None)
def max_prime_factor(n: int) -> int:
    from fftlab_torch.algos.mixed_radix import factorize

    return max(factorize(n)) if n > 1 else 1


@functools.lru_cache(maxsize=None)
def plan_factors(n: int, leaf: int = DEFAULT_LEAF) -> tuple[int, ...]:
    """Factor n into radices, each <= leaf.

    Powers of two split into near-equal power-of-two radices (2^20 ->
    1024*1024, 2^14 -> 128*128); general composites greedily group prime
    factors. Raises if a prime factor exceeds `leaf` (Bluestein territory).
    """
    if n < 1:
        raise ValueError(f"invalid transform size {n}")
    if n <= leaf:
        return (n,)
    if is_power_of_two(n):
        e = n.bit_length() - 1
        le = leaf.bit_length() - 1
        k = -(-e // le)  # ceil
        base, rem = divmod(e, k)
        return tuple([2 ** (base + 1)] * rem + [2**base] * (k - rem))
    from fftlab_torch.algos.mixed_radix import factorize

    primes = sorted(factorize(n), reverse=True)
    if primes[0] > leaf:
        raise ValueError(
            f"n={n} has prime factor {primes[0]} > leaf {leaf}; use Bluestein"
        )
    groups: list[int] = []
    for p in primes:
        for i, g in enumerate(groups):
            if g * p <= leaf:
                groups[i] = g * p
                break
        else:
            groups.append(p)
    return tuple(sorted(groups, reverse=True))


def _contract_digit(x, F, axis_from_end: int):
    """Contract the DFT matrix F[out, in] with one digit axis of x
    (0 = the last axis)."""
    if axis_from_end == 0:
        eq = "...a,ba->...b"
    else:
        tail = string.ascii_lowercase[2 : 2 + axis_from_end]
        eq = f"...a{tail},ba->...b{tail}"
    with full_float32():
        return torch.einsum(eq, x, F)


def _digit_twiddle_np(r: int, factors: tuple, direction: int):
    """The twiddles after the radix-r stage, shaped over the digit axes
    still to transform."""
    m = 1
    for f in factors:
        m *= f
    return stage_twiddle_np(r, m, direction).reshape(r, *factors)


def stage_factors(n: int, leaf: int = DEFAULT_LEAF, cap: int = STAGE_RADIX) -> tuple[int, ...]:
    """The radices the transform runs: `plan_factors` with the stages
    capped at `cap`, or at the largest prime factor where that is
    larger. Raises as `plan_factors` does for a prime factor above leaf."""
    p = max_prime_factor(n)
    if p > leaf:
        raise ValueError(f"n={n} has prime factor {p} > leaf {leaf}; use Bluestein")
    return plan_factors(n, max(min(leaf, cap), p))


def stockham_fft_unscaled(x, direction=FORWARD, leaf: int = DEFAULT_LEAF):
    """The transform without the inverse 1/n scaling."""
    x, n, direction = prepare(x, direction)
    if n == 1:
        return x
    return _run_stages(x, direction, stage_factors(n, leaf))


def _run_stages(x: torch.Tensor, direction, factors: tuple[int, ...]) -> torch.Tensor:
    """The unscaled transform of x [..., n] through the radices `factors`
    (their product n)."""
    n = x.shape[-1]
    K = len(factors)
    if K == 1:
        return _contract_digit(x, table(dft_matrix_np, n, direction, like=x), 0)
    batch = x.shape[:-1]
    bnd = len(batch)
    x = x.reshape(*batch, *factors)
    for i, r in enumerate(factors):
        x = _contract_digit(x, table(dft_matrix_np, r, direction, like=x), K - 1 - i)
        if i < K - 1:
            x = x * table(_digit_twiddle_np, r, factors[i + 1 :], int(direction), like=x)
    # digit-reversed readout: one transpose of the factor axes
    perm = tuple(range(bnd)) + tuple(range(bnd + K - 1, bnd - 1, -1))
    return x.permute(perm).reshape(*batch, n)


def stockham_fft(x, direction=FORWARD, leaf: int = DEFAULT_LEAF):
    """Mixed-radix matmul FFT (any n whose prime factors are <= leaf)."""
    x, n, direction = prepare(x, direction)
    return inverse_scale(stockham_fft_unscaled(x, direction, leaf), n, direction)


def supports(n: int, leaf: int = DEFAULT_LEAF) -> bool:
    return n >= 1 and max_prime_factor(n) <= leaf


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("stockham_fft", stockham_fft, device=demo_device())
