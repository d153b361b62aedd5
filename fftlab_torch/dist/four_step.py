"""Four-step FFT on one device (counterpart of fftlab/dist/four_step.py:49-111):
one transform as n = n1*n2. The sharded form, where the transpose is a
collective between devices, is not ported yet (ROADMAP Queue 1 item 12).

With j = j1 + n1*j2 and k = k2 + n2*k1, on B[j2, j1] = x.reshape(n2, n1):
  1. FFT_{n2} over j2,  2. multiply by W_n^{j1*k2},  3. FFT_{n1} over j1,
  4. Y[k1, k2] = the result transposed; X = Y.reshape(n).
"""

from __future__ import annotations

import math

import torch

from fftlab_torch.algos._common import inverse_scale, prepare
from fftlab_torch.algos.stockham import stockham_fft_unscaled
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two, log2_int


def split_n(n: int, n1: int | None = None) -> tuple[int, int]:
    """The n = n1*n2 factorization: n1 ~ sqrt(n), both powers of two for
    pow2 n; otherwise the largest divisor <= sqrt(n)."""
    if n1 is not None:
        if n % n1:
            raise ValueError(f"n1={n1} does not divide n={n}")
        return n1, n // n1
    if is_power_of_two(n):
        n1 = 1 << (log2_int(n) // 2)
        return n1, n // n1
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best, n // best


def _stage_twiddle(n1: int, n2: int, n: int, direction: Direction, like: torch.Tensor):
    """W_n^{j1*k2} as (n1, n2), computed on the device in `like`'s real
    dtype from the exact integer phase j1*k2 mod n, as the JAX function
    computes it."""
    rdtype = like.real.dtype
    j1 = torch.arange(n1, device=like.device)[:, None]
    k2 = torch.arange(n2, device=like.device)[None, :]
    step = torch.tensor(2.0 * math.pi * float(int(direction)) / n, dtype=rdtype,
                        device=like.device)
    ang = ((j1 * k2) % n).to(rdtype) * step
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(like.dtype)


def four_step_fft(x, direction=FORWARD, n1: int | None = None, cfft=None):
    """Single-device four-step FFT: two batched passes of sqrt(n)-point
    transforms around one twiddle multiply."""
    x, n, direction = prepare(x, direction)
    if cfft is None:
        cfft = stockham_fft_unscaled
    n1, n2 = split_n(n, n1)
    if n1 == 1 or n2 == 1:
        return inverse_scale(cfft(x, direction), n, direction)
    batch = x.shape[:-1]
    b = x.reshape(*batch, n2, n1)
    c = cfft(b.transpose(-1, -2), direction)  # [..., n1, n2] = C[j1, k2]
    c = c * _stage_twiddle(n1, n2, n, direction, x)
    d = cfft(c.transpose(-1, -2), direction)  # [..., n2, n1] = D[k2, k1]
    y = d.transpose(-1, -2).reshape(*batch, n)  # Y[k1, k2] = D[k2, k1]
    return inverse_scale(y, n, direction)
