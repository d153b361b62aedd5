"""Split re/im Stockham FFT in tensor ops: the `einsum` route, the real
transforms built on a half-size complex FFT, and the FFT -> H -> IFFT
sandwich in tensor ops (counterpart of fftlab/algos/split_stockham.py).

Same algorithm as the JAX package: n is factored into radices of at
most `leaf`, each stage contracts one digit axis with that radix's DFT
matrix (four real einsums per complex contraction), the inter-stage
twiddles are one complex multiply, and the digit reversal is a single
final transpose. This route has no kernel of its own, as the JAX package
leaves it to XLA.

The contractions are float32 matmuls, and the route pins full float32
itself (core/precision.py `full_float32`), as the JAX package pins
`Precision.HIGHEST`: whatever the caller set with
`torch.set_float32_matmul_precision` or `allow_tf32`, they run at
"highest" with TF32 off (TF32 or bfloat16 would cost 60-70 dB of SNR),
and the caller's setting is back when the call returns.
"""

from __future__ import annotations

import functools
import os
import string

import numpy as np
import torch

from fftlab_torch.algos.stockham import max_prime_factor, plan_factors
from fftlab_torch.core.precision import full_float32
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
    with full_float32():
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


def _unpack_paired(Zr, Zi, n: int):
    """The paired Hermitian unpack in tensor ops (m = n/2 even,
    split_stockham.py:214-242): bins k and m-k from one E, W*O
    computation, every intermediate m/2+1 wide."""
    m = n // 2
    half = m // 2
    zlr, zli = Zr[..., : half + 1], Zi[..., : half + 1]
    # Zh[k] = Z[(m-k) % m] for k = 0..m/2: [Z[0], Z[m-1]..Z[m/2]]
    zhr = torch.cat([Zr[..., :1], torch.flip(Zr[..., half:], [-1])], dim=-1)
    zhi = torch.cat([Zi[..., :1], torch.flip(Zi[..., half:], [-1])], dim=-1)
    er, ei = 0.5 * (zlr + zhr), 0.5 * (zli - zhi)
    o_r, o_i = 0.5 * (zli + zhi), -0.5 * (zlr - zhr)
    k = np.arange(half + 1, dtype=np.float64)
    wr, wi = _planes(np.exp(-2j * np.pi * k / n), Zr)
    wor, woi = _twiddle_split(o_r, o_i, wr, wi)
    low_r, low_i = er + wor, ei + woi  # bins 0..m/2
    high_r, high_i = er - wor, -(ei - woi)  # conj(E - W*O)
    # bins m/2+1..m-1 ascending are k = m/2-1 .. 1; bin m is k = 0
    return (torch.cat([low_r, torch.flip(high_r[..., 1:half], [-1]), high_r[..., :1]], -1),
            torch.cat([low_i, torch.flip(high_i[..., 1:half], [-1]), high_i[..., :1]], -1))


def _unpack_unpaired(Zr, Zi, n: int):
    """The unpaired Hermitian unpack (m = n/2 odd, split_stockham.py:
    243-256): Z extended by Z[0], X = E + W*O over all n/2+1 bins."""
    Zr = torch.cat([Zr, Zr[..., :1]], dim=-1)
    Zi = torch.cat([Zi, Zi[..., :1]], dim=-1)
    zrr, zri = torch.flip(Zr, [-1]), -torch.flip(Zi, [-1])  # conj(Z[m-k])
    er, ei = 0.5 * (Zr + zrr), 0.5 * (Zi + zri)
    k = np.arange(int(Zr.shape[-1]), dtype=np.float64)
    wr, wi = _planes(np.exp(-2j * np.pi * k / n), Zr)
    wor, woi = _twiddle_split(0.5 * (Zi - zri), -0.5 * (Zr - zrr), wr, wi)
    return er + wor, ei + woi


def _repack_unpaired(Xr, Xi, n: int):
    """The unpaired Hermitian repack (m = n/2 odd, split_stockham.py:
    326-337): Z = E + i*W^-k*D over all bins, cut to m."""
    h = int(Xr.shape[-1])
    xrr, xri = torch.flip(Xr, [-1]), -torch.flip(Xi, [-1])
    er, ei = 0.5 * (Xr + xrr), 0.5 * (Xi + xri)
    k = np.arange(h, dtype=np.float64)
    wr, wi = _planes(np.exp(2j * np.pi * k / n), Xr)
    o_r, o_i = _twiddle_split(0.5 * (Xr - xrr), 0.5 * (Xi - xri), wr, wi)
    return (er - o_i)[..., : n // 2], (ei + o_r)[..., : n // 2]


def _fused_enabled() -> bool:
    """FFTLAB_RFFT_FUSED=0 opts out of the fused r2c/c2r kernels, as in
    the JAX package (split_stockham.py:191); bench.py's fused/pipeline
    A/B sets it."""
    return os.environ.get("FFTLAB_RFFT_FUSED", "1") != "0"


def rfft_split(x: torch.Tensor, leaf: int = DEFAULT_LEAF_SPLIT, cfft=None):
    """Real-input FFT on the split path: real float32 [..., n] -> (re, im)
    of the n//2+1 one-sided bins, by the pack-two-reals trick.

    Routes, by n (and by whether `cfft` is given), never by device:
      odd n or n < 4     the complex `fft_split` of (x, 0), Bluestein
                         included, cut to n//2+1 bins;
      the fused kernels  n/2 pow2 in 2^15..2^20 with the default cfft
                         (kernels/rfft_resident.py; FFTLAB_RFFT_FUSED=0
                         opts out);
      pack -> cfft -> unpack kernels where kernels.rfft_vmem.pack_supported(n);
      tensor ops         the paired unpack (n/2 even) or the unpaired one,
                         on any device (the JAX package leaves them to XLA).
    `cfft(re, im) -> (re, im)` overrides the half-size complex transform;
    the default is `fft_split`, the einsum route. Another dtype than
    float32 is refused, not cast."""
    from fftlab_torch.kernels._common import check_real
    from fftlab_torch.kernels.rfft_vmem import (pack_supported,
                                                pallas_hermitian_unpack,
                                                pallas_pack_real)

    check_real(x, "rfft_split")
    cfft_default = cfft is None
    if cfft is None:
        cfft = lambda a, b: fft_split(a, b, FORWARD, leaf)
    n = int(x.shape[-1])
    h = n // 2 + 1
    if n % 2 or n < 4:
        zr, zi = fft_split(x, torch.zeros_like(x), FORWARD, leaf)
        return zr[..., :h], zi[..., :h]
    if cfft_default and _fused_enabled():
        from fftlab_torch.kernels.rfft_resident import (rfft_resident,
                                                        supported_rfft_resident)

        if supported_rfft_resident(n):
            return rfft_resident(x)
    if pack_supported(n):
        Zr, Zi = cfft(*pallas_pack_real(x))
        return pallas_hermitian_unpack(Zr, Zi, n)
    Zr, Zi = cfft(x[..., 0::2], x[..., 1::2])
    if (n // 2) % 2 == 0:
        return _unpack_paired(Zr, Zi, n)
    return _unpack_unpaired(Zr, Zi, n)


def irfft_split(Xr: torch.Tensor, Xi: torch.Tensor, n: int | None = None,
                leaf: int = DEFAULT_LEAF_SPLIT, cfft=None):
    """One-sided (re, im) float32 spectrum -> real [..., n], 1/n scaled
    (the inverse of rfft_split), with the routes of rfft_split: the fused
    kernels where n = 2(h-1) fits them and `cfft` is the default; else
    the paired repack (n/2 even; the `herm_repack` kernel on a CUDA
    tensor, where the JAX package runs it in XLA) or the unpaired one in
    tensor ops, `cfft`, and the `interleave` kernel where pack_supported(n)
    (a stack otherwise). `cfft(re, im) -> (re, im)` overrides the
    half-size inverse complex transform and must apply its 1/(n/2)."""
    from fftlab_torch.kernels._common import check_planes
    from fftlab_torch.kernels.rfft_vmem import (hermitian_repack,
                                                pack_supported,
                                                pallas_interleave)

    check_planes(Xr, Xi, "irfft_split")
    h = int(Xr.shape[-1])
    if n is None:
        n = 2 * (h - 1)
    if cfft is None and n == 2 * (h - 1) and _fused_enabled():
        from fftlab_torch.kernels.rfft_resident import (irfft_resident,
                                                        supported_rfft_resident)

        if supported_rfft_resident(n):
            return irfft_resident(Xr, Xi)
    if n % 2 or n < 4:
        tr = torch.flip(Xr[..., 1 : n - h + 1], [-1])
        ti = -torch.flip(Xi[..., 1 : n - h + 1], [-1])
        fr = torch.cat([Xr[..., :h], tr], dim=-1)
        fi = torch.cat([Xi[..., :h], ti], dim=-1)
        yr, _ = fft_split(fr, fi, Direction.INVERSE, leaf)
        return yr
    m = n // 2
    if m % 2 == 0:
        Zr, Zi = hermitian_repack(Xr[..., : m + 1].contiguous(),
                                  Xi[..., : m + 1].contiguous(), n)
    else:
        Zr, Zi = _repack_unpaired(Xr, Xi, n)
    if cfft is None:
        cfft = lambda a, b: fft_split(a, b, Direction.INVERSE, leaf)
    zr, zi = cfft(Zr, Zi)
    if pack_supported(n):
        return pallas_interleave(zr, zi)
    return torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], n)


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
