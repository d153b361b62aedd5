"""Split re/im Stockham FFT in tensor ops: the `einsum` route, and the
FFT -> H -> IFFT sandwich in tensor ops (counterpart of
fftlab/algos/split_stockham.py:54-151 and :355-509).

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

import functools
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


def _twiddle_split(xr, xi, twr, twi):
    """(xr + i*xi) * (twr + i*twi) on real planes."""
    return xr * twr - xi * twi, xr * twi + xi * twr


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
            xr, xi = _twiddle_split(xr, xi, *_planes(tw, xr))
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
        # a prime factor above the leaf: the chirp-z transform, whose
        # convolution is the filter sandwich at a power of two
        from fftlab_torch.algos.bluestein import bluestein_fft_split

        return bluestein_fft_split(xr, xi, direction)
    yr, yi = stockham_fft_split_unscaled(xr, xi, direction, leaf)
    if direction == Direction.INVERSE:
        return yr * (1.0 / n), yi * (1.0 / n)
    return yr, yi


def ifft_split(xr: torch.Tensor, xi: torch.Tensor,
               leaf: int = DEFAULT_LEAF_SPLIT):
    return fft_split(xr, xi, Direction.INVERSE, leaf)


def spectral_filter_split(xr: torch.Tensor, xi: torch.Tensor, hr, hi,
                          leaf: int = DEFAULT_LEAF_SPLIT):
    """The FFT -> H -> IFFT sandwich on split planes, 1/n scaled; H in
    natural bin order (tensors on the planes' device)."""
    Xr, Xi = stockham_fft_split_unscaled(xr, xi, FORWARD, leaf)
    Yr, Yi = _twiddle_split(Xr, Xi, hr, hi)
    n = int(xr.shape[-1])
    yr, yi = stockham_fft_split_unscaled(Yr, Yi, Direction.INVERSE, leaf)
    return yr * (1.0 / n), yi * (1.0 / n)


# The transpose-free sandwich. The forward stages leave the spectrum in
# digit-reversed order, and `stockham_fft_split_unscaled` fixes that with
# one final transpose. The pointwise multiply does not care about bin
# order, so the fused sandwich skips that transpose, multiplies by a
# digit-reversed copy of H (built once on the host), and inverts with the
# stages applied backwards with conjugated tables, which consumes
# digit-reversed input and emits natural order.


def _fft_split_digitrev(xr, xi, direction, factors):
    """Forward stages only: output [..., n] in digit-reversed order (axes
    (k_0..k_{K-1}) flattened; spectrum bin k = k_0 + f_0*(k_1 + ...))."""
    batch = tuple(xr.shape[:-1])
    K = len(factors)
    n = int(np.prod(factors))
    xr = xr.reshape(*batch, *factors)
    xi = xi.reshape(*batch, *factors)
    rem = n
    for i, r in enumerate(factors):
        Fr, Fi = _planes(dft_matrix_np(r, direction), xr)
        xr, xi = _contract_split(xr, xi, Fr, Fi, K - 1 - i)
        if i < K - 1:
            m = rem // r
            tw = stage_twiddle_np(r, m, direction).reshape(r, *factors[i + 1:])
            xr, xi = _twiddle_split(xr, xi, *_planes(tw, xr))
            rem = m
    return xr.reshape(*batch, n), xi.reshape(*batch, n)


def _ifft_split_from_digitrev(yr, yi, direction, factors):
    """Exact inverse of `_fft_split_digitrev`: the stages in reverse with
    conjugated tables. Digit-reversed order in, natural order out;
    unscaled (the caller applies 1/n)."""
    inv_dir = Direction(-int(direction))
    batch = tuple(yr.shape[:-1])
    K = len(factors)
    n = int(np.prod(factors))
    yr = yr.reshape(*batch, *factors)
    yi = yi.reshape(*batch, *factors)
    rem_sizes = []
    rem = n
    for r in factors:
        rem_sizes.append(rem)
        rem //= r
    for i in range(K - 1, -1, -1):
        r = factors[i]
        if i < K - 1:
            m = rem_sizes[i] // r
            tw = stage_twiddle_np(r, m, inv_dir).reshape(r, *factors[i + 1:])
            yr, yi = _twiddle_split(yr, yi, *_planes(tw, yr))
        Fr, Fi = _planes(dft_matrix_np(r, inv_dir), yr)
        yr, yi = _contract_split(yr, yi, Fr, Fi, K - 1 - i)
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


@functools.lru_cache(maxsize=None)
def digitrev_bins(factors: tuple) -> np.ndarray:
    """bins[p] = the spectrum bin held at row-major position p of the
    digit-reversed layout: p <-> digits (k_0..k_{K-1}) row-major and
    bin = k_0 + f_0*(k_1 + f_1*(k_2 + ...)). So
    digitrev_output[..., p] == spectrum[..., bins[p]], and H[..., bins]
    is H in digit-reversed layout."""
    n = int(np.prod(factors))
    weights = []
    w = 1
    for f in factors:
        weights.append(w)
        w *= f
    pos_strides = []
    s = 1
    for f in reversed(factors):
        pos_strides.append(s)
        s *= f
    pos_strides = pos_strides[::-1]
    rem = np.arange(n)
    bins = np.zeros(n, dtype=np.int64)
    for i in range(len(factors)):
        k_i = rem // pos_strides[i]
        rem = rem % pos_strides[i]
        bins += k_i * weights[i]
    return bins


def permute_response(hr, hi, n: int, leaf: int = DEFAULT_LEAF_SPLIT):
    """Digit-reverse a host (numpy) frequency response at plan time, for
    `spectral_filter_split_fused(..., h_permuted=True)`."""
    factors = plan_factors(n, leaf)
    if len(factors) == 1:
        return np.asarray(hr), np.asarray(hi)
    bins = digitrev_bins(factors)
    return (np.ascontiguousarray(np.asarray(hr)[..., bins]),
            np.ascontiguousarray(np.asarray(hi)[..., bins]))


def _as_planes(h, like: torch.Tensor) -> torch.Tensor:
    """A response plane (numpy or tensor) as a tensor of `like`'s dtype
    and device."""
    return torch.as_tensor(h, dtype=like.dtype, device=like.device)


def spectral_filter_split_fused(xr: torch.Tensor, xi: torch.Tensor, hr, hi,
                                leaf: int = DEFAULT_LEAF_SPLIT,
                                h_permuted: bool = False):
    """FFT -> H -> IFFT with no transposes: the pointwise multiply runs in
    digit-reversed bin order on a digit-reversed H, 1/n scaled.

    H is numpy (permuted here on the host) or a tensor (permuted by one
    gather on its device); pass a plan-time `permute_response` copy with
    `h_permuted=True` to skip both."""
    n = int(xr.shape[-1])
    factors = plan_factors(n, leaf)
    if len(factors) == 1:
        return spectral_filter_split(xr, xi, _as_planes(hr, xr),
                                     _as_planes(hi, xr), leaf)
    if h_permuted:
        hr_p, hi_p = hr, hi
    elif isinstance(hr, torch.Tensor) or isinstance(hi, torch.Tensor):
        bins = torch.from_numpy(digitrev_bins(factors)).to(xr.device)
        hr_p = _as_planes(hr, xr)[..., bins]
        hi_p = _as_planes(hi, xr)[..., bins]
    else:
        hr_p, hi_p = permute_response(hr, hi, n, leaf)
    Yr, Yi = _fft_split_digitrev(xr, xi, FORWARD, factors)
    Gr, Gi = _twiddle_split(Yr, Yi, _as_planes(hr_p, xr), _as_planes(hi_p, xr))
    zr, zi = _ifft_split_from_digitrev(Gr, Gi, FORWARD, factors)
    return zr * (1.0 / n), zi * (1.0 / n)
