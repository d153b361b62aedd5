"""Two-pass four-step FFT for power-of-two n in 2^15..2^21: the
`two_pass` route (counterpart of fftlab/kernels/fourstep_vmem.py).

n = L1*L2 (`_split_sides`, L1 <= L2), j = j1*L2 + j2, k = k2*L1 + k1:

  pass 1  column FFTs of length L1 over j1 for every j2, then the
          four-step twiddle W_n^{k1*j2}, into a row-major (B, L1, L2)
          intermediate;
  pass 2  row FFTs of length L2 over j2 for every k1, stored at
          [k2, k1], which flattens to the natural spectrum order.

On a CUDA tensor the hand-written kernels `fourstep_pass1` and
`fourstep_pass2` (csrc/fourstep.cu) run. On a CPU tensor the plain
version runs: the JAX kernel's math in tensor ops with the same tables,
the length-L FFT as the fa*fb contraction pair of `_col_fft_vmem` and
the pass-1 twiddle in the rank-1 form A[c, k1]*P[k1, l] of
`_rank1_twiddle_np`. Forward unscaled, inverse 1/n; `scale` multiplies
the output on top and is folded into pass 2 only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.core.twiddle import dft_matrix_np
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two, log2_int
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (
    check_cuda,
    check_planes,
    complex_table,
    effective_scale,
    on_cpu,
    rows_of,
    stream_of,
    twiddle_np,
)

MIN_N = 1 << 15
MAX_N = 1 << 21

# Columns per pass-1 block: 16 floats = 64 contiguous bytes per j1 row.
PASS1_WIDTH = 16
# Complex values of one shared-memory tile (csrc/fft_smem.cuh kMaxTile).
MAX_TILE = 16384

# Launches of the CUDA kernels since the counts were last reset.
LAUNCHES = {"fourstep_pass1": 0, "fourstep_pass2": 0}


def supported_large(n: int) -> bool:
    return is_power_of_two(n) and MIN_N <= n <= MAX_N


def _split_sides(n: int) -> tuple[int, int]:
    """n = L1*L2, both pow2, L1 <= L2."""
    e = log2_int(n)
    L1 = 1 << (e // 2)
    return L1, n // L1


def _split_factors(L: int) -> tuple[int, int]:
    """L = fa*fb, balanced, fa <= fb."""
    e = log2_int(L)
    fa = 1 << (e // 2)
    return fa, L // fa


def _pass2_rows(L2: int) -> int:
    """Rows per pass-2 block: 16, or fewer where a tile of R rows would
    pass MAX_TILE (8 at L2 = 2048)."""
    return min(16, MAX_TILE // L2)


def _col_fft_tables(L: int, direction: Direction, scale: float | None = None):
    """Host tables for a length-L FFT as a contraction pair: Fa, Fb and the
    inter-stage twiddle W_L^{k1a*j1b}, each as (re, im) float32 numpy
    (built in float64). `scale` folds a normalization into Fb, the last
    contraction. Equal to the JAX package's tables."""
    fa, fb = _split_factors(L)
    Fa = dft_matrix_np(fa, direction)
    Fb = dft_matrix_np(fb, direction)
    if scale is not None:
        Fb = Fb * float(scale)
    ka = np.arange(fa).reshape(fa, 1)
    jb = np.arange(fb).reshape(1, fb)
    tw = np.exp(2j * np.pi * float(int(direction)) * ka * jb / L)
    c = lambda a: np.ascontiguousarray(a).astype(np.float32)
    return (c(Fa.real), c(Fa.imag), c(Fb.real), c(Fb.imag),
            c(tw.real), c(tw.imag))


def _rank1_twiddle_np(L1: int, L2: int, W: int, direction: Direction):
    """The pass-1 twiddle W_n^{k1*j2} split along j2 = c*W + l:
    A[c, k1] = W_n^{k1*c*W},  P[k1, l] = W_n^{k1*l}  (both float64).
    Returns (A as (C, L1, 1), P as (L1, W))."""
    n = L1 * L2
    C = L2 // W
    k1 = np.arange(L1, dtype=np.int64)
    c = np.arange(C, dtype=np.int64)
    l = np.arange(W, dtype=np.int64)
    s = 2j * np.pi * float(int(direction)) / n
    A = np.exp(s * ((c[:, None] * W * k1[None, :]) % n))  # (C, L1)
    P = np.exp(s * ((k1[:, None] * l[None, :]) % n))      # (L1, W)
    return A.reshape(C, L1, 1), P


def _col_fft(xr, xi, tabs, fa: int, fb: int):
    """(B, L, W) -> (B, L, W): length-L FFT down axis 1, natural order
    (`_col_fft_vmem`): contract j1a, twiddle, contract j1b; the output
    axis order (k1b, k1a) is the digit reversal."""
    Far, Fai, Fbr, Fbi, twr, twi = tabs
    B, L, W = xr.shape
    x3r = xr.reshape(B, fa, fb * W)
    x3i = xi.reshape(B, fa, fb * W)
    sr = torch.matmul(Far, x3r) - torch.matmul(Fai, x3i)
    si = torch.matmul(Far, x3i) + torch.matmul(Fai, x3r)
    sr = sr.reshape(B, fa, fb, W)
    si = si.reshape(B, fa, fb, W)
    wr = twr.reshape(fa, fb, 1)
    wi = twi.reshape(fa, fb, 1)
    tr = sr * wr - si * wi
    ti = sr * wi + si * wr
    # (fb, fb) @ (B, fa, fb, W) contracts j1b -> (B, fa, k1b, W)
    yr = torch.matmul(Fbr, tr) - torch.matmul(Fbi, ti)
    yi = torch.matmul(Fbr, ti) + torch.matmul(Fbi, tr)
    return (yr.transpose(1, 2).reshape(B, L, W),
            yi.transpose(1, 2).reshape(B, L, W))


@functools.lru_cache(maxsize=32)
def _plain_col_tables(L: int, direction: Direction, scale: float,
                      device: torch.device):
    tabs = _col_fft_tables(L, direction, None if scale == 1.0 else scale)
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


@functools.lru_cache(maxsize=32)
def _plain_pass1_twiddle(n: int, direction: Direction, device: torch.device):
    """W_n^{k1*j2} as (L1, L2) planes from the rank-1 factors, multiplied
    in float32 as the kernel multiplies them."""
    L1, L2 = _split_sides(n)
    A, P = _rank1_twiddle_np(L1, L2, PASS1_WIDTH, direction)
    Ar, Ai, Pr, Pi = (torch.from_numpy(a.astype(np.float32)).to(device)
                      for a in (A.real, A.imag, P.real, P.imag))
    wr = Ar * Pr - Ai * Pi  # (C, L1, W)
    wi = Ar * Pi + Ai * Pr
    return (wr.permute(1, 0, 2).reshape(L1, L2),  # [k1, j2 = c*W + l]
            wi.permute(1, 0, 2).reshape(L1, L2))


def fourstep_pass1_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Plain version of pass 1 on [B, n] planes -> the (B, L1, L2)
    intermediate planes, flattened to [B, n]."""
    direction = Direction(int(direction))
    B, n = xr.shape
    L1, L2 = _split_sides(n)
    fa, fb = _split_factors(L1)
    tabs = _plain_col_tables(L1, direction, 1.0, xr.device)
    yr, yi = _col_fft(xr.reshape(B, L1, L2), xi.reshape(B, L1, L2), tabs, fa, fb)
    wr, wi = _plain_pass1_twiddle(n, direction, xr.device)
    return ((yr * wr - yi * wi).reshape(B, n),
            (yr * wi + yi * wr).reshape(B, n))


def fourstep_pass2_plain(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                         scale: float = 1.0):
    """Plain version of pass 2: intermediate [B, n] planes -> natural-order
    spectrum; `scale` is the whole output scale."""
    direction = Direction(int(direction))
    B, n = mr.shape
    L1, L2 = _split_sides(n)
    fa, fb = _split_factors(L2)
    tabs = _plain_col_tables(L2, direction, float(scale), mr.device)
    # rows of the (L1, L2) matrix as columns: (B, L2 = j2, L1 = k1)
    yr, yi = _col_fft(mr.reshape(B, L1, L2).transpose(1, 2),
                      mi.reshape(B, L1, L2).transpose(1, 2), tabs, fa, fb)
    # (B, L2 = k2, L1 = k1) flattens to k = k2*L1 + k1: natural order
    return yr.reshape(B, n), yi.reshape(B, n)


@functools.lru_cache(maxsize=32)
def _pass1_tables(n: int, direction: Direction, device: torch.device):
    L1, L2 = _split_sides(n)
    A, P = _rank1_twiddle_np(L1, L2, PASS1_WIDTH, direction)
    return (complex_table(twiddle_np(L1, direction), device),
            complex_table(A.reshape(-1, L1), device),
            complex_table(P, device))


@functools.lru_cache(maxsize=32)
def _pass2_twiddle(L2: int, direction: Direction, device: torch.device):
    return complex_table(twiddle_np(L2, direction), device)


def _check_launch(xr, xi, name: str) -> int:
    check_planes(xr, xi, name)
    check_cuda(xr, xi, name=name)
    n = int(xr.shape[-1])
    if xr.dim() != 2 or not supported_large(n):
        raise ValueError(f"{name} takes [B, n] planes, pow2 n in "
                         f"[{MIN_N}, {MAX_N}]; got {tuple(xr.shape)}")
    return n


def fourstep_pass1(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Launch pass 1 on contiguous [B, n] CUDA planes; returns the
    intermediate planes [B, n] (row-major (B, L1, L2))."""
    direction = Direction(int(direction))
    n = _check_launch(xr, xi, "fourstep_pass1")
    L1, L2 = _split_sides(n)
    lib = _build.load_library()
    mr = torch.empty_like(xr)
    mi = torch.empty_like(xi)
    tw1, a_tab, p_tab = _pass1_tables(n, direction, xr.device)
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_fourstep_pass1(
            xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(),
            tw1.data_ptr(), a_tab.data_ptr(), p_tab.data_ptr(), xr.shape[0],
            log2_int(L1), log2_int(L2), log2_int(PASS1_WIDTH), int(direction),
            stream_of(xr))
    _build.check(lib, "fourstep_pass1", rc)
    LAUNCHES["fourstep_pass1"] += 1
    return mr, mi


def fourstep_pass2(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                   scale: float = 1.0):
    """Launch pass 2 on the contiguous [B, n] intermediate planes; returns
    the natural-order spectrum. `scale` is the whole output scale."""
    direction = Direction(int(direction))
    n = _check_launch(mr, mi, "fourstep_pass2")
    L1, L2 = _split_sides(n)
    lib = _build.load_library()
    yr = torch.empty_like(mr)
    yi = torch.empty_like(mi)
    tw2 = _pass2_twiddle(L2, direction, mr.device)
    with torch.cuda.device(mr.device):
        rc = lib.fftlab_fourstep_pass2(
            mr.data_ptr(), mi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw2.data_ptr(), mr.shape[0], log2_int(L1), log2_int(L2),
            log2_int(_pass2_rows(L2)), int(direction), float(scale),
            stream_of(mr))
    _build.check(lib, "fourstep_pass2", rc)
    LAUNCHES["fourstep_pass2"] += 1
    return yr, yi


def fft_split_large(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                    scale: float | None = None):
    """Batched FFT on split planes [..., n], pow2 n in 2^15..2^21: the two
    CUDA kernels for a CUDA tensor, the plain version for a CPU tensor.
    Forward unscaled / inverse 1/n, natural order; `scale` multiplies on
    top, folded into pass 2."""
    check_planes(xr, xi, "fft_split_large")
    n = int(xr.shape[-1])
    if not supported_large(n):
        raise ValueError(
            f"fft_split_large supports pow2 n in [{MIN_N}, {MAX_N}]; got {n}")
    eff = effective_scale(n, direction, scale)
    B = rows_of(xr.shape)
    x2r, x2i = xr.reshape(B, n), xi.reshape(B, n)
    if on_cpu(xr, "fft_split_large"):
        mr, mi = fourstep_pass1_plain(x2r, x2i, direction)
        yr, yi = fourstep_pass2_plain(mr, mi, direction, eff)
    else:
        mr, mi = fourstep_pass1(x2r, x2i, direction)
        yr, yi = fourstep_pass2(mr, mi, direction, eff)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)
