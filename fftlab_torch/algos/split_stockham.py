"""Split re/im Stockham FFT in tensor ops: the `einsum` route
(counterpart of fftlab/algos/split_stockham.py:54-151).

Same algorithm as the JAX package: n is factored into radices of at
most `leaf`, each stage contracts one digit axis with that radix's DFT
matrix (four real einsums per complex contraction), the inter-stage
twiddles are one complex multiply, and the digit reversal is a single
final transpose. This route has no kernel of its own, as the JAX package
leaves it to XLA.

On a CUDA tensor the contractions are float32 matmuls, which must not run
in TF32 (`torch.backends.cuda.matmul.allow_tf32`, False by default):
TF32 costs about 60 dB of SNR.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from fftlab_torch.algos.stockham import max_prime_factor, plan_factors
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import FORWARD, Direction

DEFAULT_LEAF_SPLIT = 128


def _planes(a: np.ndarray, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex128 numpy table -> (re, im) tensors of `like`'s dtype and device."""
    as_t = lambda p: torch.from_numpy(np.ascontiguousarray(p)).to(
        device=like.device, dtype=like.dtype)
    return as_t(a.real), as_t(a.imag)


def _contract_split(xr, xi, Fr, Fi, axis_from_end: int):
    """Complex contraction of one digit axis, expanded to real einsums."""
    if axis_from_end == 0:
        eq = "...a,ba->...b"
    else:
        tail = string.ascii_lowercase[2 : 2 + axis_from_end]
        eq = f"...a{tail},ba->...b{tail}"
    yr = torch.einsum(eq, xr, Fr) - torch.einsum(eq, xi, Fi)
    yi = torch.einsum(eq, xr, Fi) + torch.einsum(eq, xi, Fr)
    return yr, yi


def stockham_fft_split_unscaled(xr: torch.Tensor, xi: torch.Tensor,
                                direction=FORWARD,
                                leaf: int = DEFAULT_LEAF_SPLIT):
    """Forward/backward transform on split planes, no inverse scaling."""
    if xr.shape != xi.shape:
        raise ValueError(f"re/im shape mismatch: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    if n == 1:
        return xr, xi
    factors = plan_factors(n, leaf)
    K = len(factors)
    if K == 1:
        Fr, Fi = _planes(dft_matrix_np(n, direction), xr)
        return _contract_split(xr, xi, Fr, Fi, 0)

    batch = tuple(xr.shape[:-1])
    bnd = len(batch)
    xr = xr.reshape(*batch, *factors)
    xi = xi.reshape(*batch, *factors)
    rem = n
    for i, r in enumerate(factors):
        Fr, Fi = _planes(dft_matrix_np(r, direction), xr)
        xr, xi = _contract_split(xr, xi, Fr, Fi, K - 1 - i)
        if i < K - 1:
            m = rem // r
            tw = stage_twiddle_np(r, m, direction).reshape(r, *factors[i + 1 :])
            twr, twi = _planes(tw, xr)
            xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
            rem = m
    perm = tuple(range(bnd)) + tuple(range(bnd + K - 1, bnd - 1, -1))
    xr = xr.permute(perm).reshape(*batch, n)
    xi = xi.permute(perm).reshape(*batch, n)
    return xr, xi


def fft_split(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
              leaf: int = DEFAULT_LEAF_SPLIT):
    """Split-complex FFT over the last axis: (re, im) -> (re, im).

    Forward unscaled; inverse scaled by 1/n."""
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    if n > 1 and max_prime_factor(n) > leaf:
        raise NotImplementedError(
            f"n={n} has a prime factor above the leaf {leaf}: Bluestein is "
            "not ported yet (ROADMAP Queue 1 item 7)")
    yr, yi = stockham_fft_split_unscaled(xr, xi, direction, leaf)
    if direction == Direction.INVERSE:
        return yr * (1.0 / n), yi * (1.0 / n)
    return yr, yi


def ifft_split(xr: torch.Tensor, xi: torch.Tensor,
               leaf: int = DEFAULT_LEAF_SPLIT):
    return fft_split(xr, xi, Direction.INVERSE, leaf)
