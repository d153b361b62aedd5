"""Four-step FFT (counterpart of fftlab/dist/four_step.py): one
transform as n = n1*n2, on one device (`four_step_fft`, :49-111) or
sharded over a mesh axis with the transpose as an `all_to_all` between
ranks (`four_step_fft_sharded`, :111-183).

With j = j1 + n1*j2 and k = k2 + n2*k1, on B[j2, j1] = x.reshape(n2, n1):
  1. FFT_{n2} over j2,  2. multiply by W_n^{j1*k2},  3. FFT_{n1} over j1,
  4. Y[k1, k2] = the result transposed; X = Y.reshape(n).
Sharded, each rank holds B's columns j1 in its block of n1/p, runs steps
1-2 on them, and the `all_to_all` hands it the columns k2 in its block of
n2/p for step 3. The mesh axis size must divide both n1 and n2.

This is the complex-dtype form, with local transforms on the tensor-op
Stockham (`algos/stockham.py`); `four_step_split` is the split-plane one
on the kernels.
"""

from __future__ import annotations

import functools
import math

import torch

from fftlab_torch.algos._common import inverse_scale, prepare
from fftlab_torch.algos.stockham import stockham_fft_unscaled
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two, log2_int
from fftlab_torch.dist import comm
from fftlab_torch.dist.mesh import axis, gather, on_mesh


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


def _phase(rows: int, n2: int, n: int, j1_offset: int, direction: Direction,
           device: torch.device) -> torch.Tensor:
    """The angle of W_n^{j1*k2} as float64 (rows, n2) for the rows
    j1 = j1_offset .., on the device, from the exact integer phase
    j1*k2 mod n: formed in float32, the angle at n = 2^24 would lose
    about 2^-24 * 2*pi."""
    j1 = torch.arange(j1_offset, j1_offset + rows, device=device, dtype=torch.int64)[:, None]
    k2 = torch.arange(n2, device=device, dtype=torch.int64)[None, :]
    return ((j1 * k2) % n).to(torch.float64) * (2.0 * math.pi * float(int(direction)) / n)


@functools.lru_cache(maxsize=4)
def twiddle_cs(rows: int, n2: int, n: int, j1_offset: int, direction: Direction,
               device: torch.device):
    """cos and sin of W_n^{j1*k2} as float32 (rows, n2) planes (`_phase`),
    built once per rank block, direction and device (a chunk slices its
    rows). Four tables at most stay cached: a forward and an inverse
    block of two sizes, 128 MB each at 2^24 on one rank."""
    ang = _phase(rows, n2, n, j1_offset, direction, device)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _stage_twiddle(n1: int, n2: int, n: int, direction: Direction, like: torch.Tensor,
                   j1_offset: int = 0):
    """W_n^{j1*k2} as (n1, n2) for the rows j1_offset .., in `like`'s
    complex dtype on its device (`_phase`)."""
    ang = _phase(n1, n2, n, j1_offset, direction, like.device)
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


def four_step_fft_sharded(x, mesh, axis_name: str = "tp", direction=FORWARD,
                          n1: int | None = None, flatten: bool = True):
    """One large FFT sharded over `mesh[axis_name]` with an all_to_all
    transpose between the ranks.

    x: [..., n], the same whole input on every rank (complex, or real
    promoted to complex). Returns the spectrum [..., n] on every rank if
    `flatten`, else this rank's block [..., n1, n2/p] of the matrix
    Y[k1, k2] (X[k2 + n2*k1] = Y[k1, k2]), sharded over k2: the form a
    following pointwise stage takes without a gather.
    """
    x = on_mesh(x, mesh)
    x, n, direction = prepare(x, direction)
    n1, n2 = split_n(n, n1)
    p, idx, group = axis(mesh, axis_name)
    if n1 % p or n2 % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1} and n2={n2}"
        )
    rows = n1 // p
    batch = x.shape[:-1]
    b = x.reshape(*batch, n2, n1)[..., idx * rows:(idx + 1) * rows]  # B[j2, j1 local]
    c = stockham_fft_unscaled(b.transpose(-1, -2), direction)  # C[j1 local, k2]
    c = c * _stage_twiddle(rows, n2, n, direction, c, idx * rows)
    c = comm.all_to_all(c, group, split_dim=-1, concat_dim=-2)  # [..., n1, n2/p]
    d = stockham_fft_unscaled(c.transpose(-1, -2), direction)  # D[k2 local, k1]
    y = inverse_scale(d.transpose(-1, -2).contiguous(), n, direction)  # Y[k1, k2 local]
    if flatten:
        # the flat [..., n] interleaves the blocks (X[k2 + n2*k1])
        return gather(y, mesh, axis_name, -1).reshape(*batch, n)
    return y
