"""Direction enum and integer helpers (counterpart of fftlab/core/types.py).

The split-plane path carries complex data as two float32 tensors of one
shape, so no complex type is defined here.
"""

from __future__ import annotations

import enum


class Direction(enum.IntEnum):
    """Transform direction: FORWARD = -1, INVERSE = +1; the twiddle basis
    is exp(2*pi*i*direction*k/n)."""

    FORWARD = -1
    INVERSE = 1


FORWARD = Direction.FORWARD
INVERSE = Direction.INVERSE


def is_power_of_two(n: int) -> bool:
    """True if n is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def log2_int(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two."""
    if not is_power_of_two(n):
        raise ValueError(f"log2_int requires a power of two, got {n}")
    return n.bit_length() - 1
