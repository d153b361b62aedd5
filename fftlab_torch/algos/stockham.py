"""Radix planning for the Stockham transforms (counterpart of the
planning half of fftlab/algos/stockham.py)."""

from __future__ import annotations

import functools

from fftlab_torch.core.types import is_power_of_two

DEFAULT_LEAF = 1024


def _factorize(n: int) -> tuple[int, ...]:
    """Trial-division prime factorization, smallest first."""
    if n < 1:
        raise ValueError(f"cannot factorize n={n}")
    factors = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1 if p == 2 else 2
    if m > 1:
        factors.append(m)
    return tuple(factors)


@functools.lru_cache(maxsize=None)
def max_prime_factor(n: int) -> int:
    return max(_factorize(n)) if n > 1 else 1


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
    primes = sorted(_factorize(n), reverse=True)
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
