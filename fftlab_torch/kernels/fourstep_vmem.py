"""Two-pass four-step FFT for power-of-two n in 2^15..2^21: the
`two_pass` route (counterpart of fftlab/kernels/fourstep_vmem.py).

n = L1*L2 (`_split_sides`, L1 <= L2), j = j1*L2 + j2, k = k2*L1 + k1:

  pass 1  column FFTs of length L1 over j1 for every j2, then the
          four-step twiddle W_n^{k1*j2}, into a row-major (B, L1, L2)
          intermediate;
  pass 2  row FFTs of length L2 over j2 for every k1, stored at
          [k2, k1], which flattens to the natural spectrum order.

On a CUDA tensor the hand-written kernels `fourstep_pass1` and
`fourstep_pass2` (csrc/fourstep.cu) run, on the register engine of
csrc/fft_reg.cuh at the launch geometry of `pass1_geometry` and
`pass2_geometry`. On a CPU tensor the plain version runs: the JAX
kernel's math in tensor ops, the length-L FFT as the fa*fb contraction
pair of `_col_fft_vmem`, and the pass-1 twiddle as the kernel forms it:
the rank-1 A[c, k1]*P[k1, l] of `_rank1_twiddle_np` below STAGED_MIN_L1,
S[k1 mod U, j2]*S[U + k1 div U, j2] of `_staged_twiddle_np` from it.
Forward unscaled, inverse 1/n; `scale` multiplies
the output on top and is folded into pass 2 only. `fft_split_large_ad`
is `fft_split_large` with its adjoint for autograd (kernels/_ad.py;
fftlab/kernels/fourstep_vmem.py:858).

The real-signal modes fuse K7's pack and interleave into the passes:
`fourstep_pass1_packed` reads a real [B, 2n] row as float2 pairs,
complex element j = (x[2j], x[2j+1]), and `fourstep_pass2_interleaved`
stores bin k as the float2 (y[2k], y[2k+1]) of a real [B, 2n] row; they
make the fused r2c/c2r of kernels/rfft_resident.py with pass 2's unpack
mode, `fourstep_pass2_unpack`: the length-L2 FFTs of rows k1 and L1 - k1
in one block, whose epilogue does K7's Hermitian unpack (`herm_unpack`)
on bins k and m - k and stores the one-sided [B, m+1] spectrum, so the
half-size spectrum never reaches device memory. `rfft_split_large`
and `irfft_split_large` run the half-size transform of a real signal on
these passes, or on the three-pass kernel above 2^21
(fftlab/kernels/fourstep_vmem.py:797-847).

The launch helpers take the sides (L1, L2) explicitly for the three-pass
kernel (kernels/threestep_vmem.py), which runs these passes at its own
sides and adds the swap-store mode of pass 1 (`fftlab_fourstep_pass1_swap`).
The stage pipeline (kernels/stage_fused.py) runs pass 1 in its stage mode
(`fftlab_fused_stage`, lengths 2..128, several batch rows a block) and
pass 2 in its leaf mode (`fftlab_stage_leaf`) at the launches of
`stage_geometry` and `leaf_geometry`.

`spectral_filter_large` is the FFT -> H -> IFFT sandwich on the same
passes, in the three phases of the JAX package's resident sandwich
(fftlab/kernels/resident_vmem.py `_resident_filter_kernel`: the column
FFT, `_mid`, the inverse column FFT), three launches:

  pass 1     forward, as above;
  sandwich   pass 2's sandwich mode (`fourstep_pass2_sandwich`), in
             place: per row k1 the forward length-L2 FFT, times
             H[k2*L1 + k1], the inverse length-L2 FFT, then
             W_n^{-k1*j2}/n, row k1 stored back at k1*L2 + j2;
  pass 1     inverse, in its mode with no twiddle: its store k1*L2 + j2
             is the natural order x[j1*L2 + j2].

x[L2*j1 + j2] = (1/n) sum_k1 W_L1^{-j1*k1} W_n^{-j2*k1} sum_k2
Y[k1 + L1*k2] W_L2^{-j2*k2} with Y = X*H, so the middle step needs no
corner turn; the three launches move 48 bytes a point, where the JAX
package's two-pass sandwich (fftlab/kernels/fourstep_vmem.py:667-749:
pass 1, pass 2 with H, the inverse's two passes) would move 64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np
from fftlab_torch.core.types import (FORWARD, INVERSE, Direction, is_power_of_two,
                                     log2_int)
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._ad import make_differentiable
from fftlab_torch.kernels._common import (
    TileGeometry,
    check_aligned,
    check_cuda,
    check_planes,
    check_real,
    check_response,
    complex_table,
    effective_scale,
    on_cpu,
    pass_twiddle_np,
    radix_schedule,
    response_planes,
    rows_of,
    tile_geometry,
)
from fftlab_torch.utils import trace

MIN_N = 1 << 15
MAX_N = 1 << 21

# Columns of the pass-1 rank-1 twiddle tables (csrc/fourstep.cu
# kLogTableWidth): a pass-1 block of W <= 16 columns reads its part.
PASS1_WIDTH = 16
# The shortest L1 whose twiddled pass 1 stages its W columns of S in shared
# memory (csrc/fourstep.cu kLogStagedMin); below, its store reads the
# rank-1 A and P.
STAGED_MIN_L1 = 512
# Values of a tile that lets two blocks share an SM (8K values: 512
# threads and 70 KB of exchange planes each).
SHARED_TILE = 8192
# Values of a block of the stage pipeline's kernels (256 threads,
# csrc/fourstep.cu kStageThreads), and the slack past L + L/16 of a
# stage's exchange row stride at which its tile takes one wavefront per 32
# floats under slot mapping 4 (tests/test_torch_geometry.py).
STAGE_VALUES = 4096
STAGE_SLACK = {32: 4, 64: 2, 128: 2}

# Rows R of a block of the sandwich mode at each L2 of the two-pass window:
# tiles of 4K values, the fastest R of {2, 4, 8, 16} on an H100 at 2^17,
# 2^19 and 2^20 (scripts/torch_sandwich_launches.py; at 2^15 every R reads
# the wrapper's host time), and R = 8 at 2^21, where R = 4 and 8 came
# within 4.2% of each other over four runs and 8 won three.
SANDWICH_ROWS = {256: 16, 512: 8, 1024: 4, 2048: 8}

# Consecutive rows k1 below L1/2 that a cluster of the unpack mode holds
# (csrc/fourstep.cu kLogUnpackRun): a warp stores 32 consecutive bins.
UNPACK_RUN = 32
# Bytes that a block of the unpack mode receives a bin (v, k2) of a staging
# area, a re and an im float (csrc/fourstep.cu kUnpackBinBytes), and the
# bytes of its two transaction barriers, one an area, past the low area.
UNPACK_BIN_BYTES = 8
UNPACK_BARRIER_BYTES = 16
# Rows R of a block of the unpack mode at each L2 of the fused r2c's window
# (kernels/rfft_resident.py; csrc/fourstep.cu's dispatch), the faster of 8
# and 16 on an H100 at 2^24 points (scripts/torch_r2c_pass2_sweep.py;
# PERF.md §6).
UNPACK_ROWS = {256: 16, 512: 8, 1024: 8}

# Launches of the CUDA kernels since the counts were last reset.
LAUNCHES = {"fourstep_pass1": 0, "fourstep_pass2": 0,
            "fourstep_pass2_sandwich": 0, "fourstep_pass1_packed": 0,
            "fourstep_pass2_interleaved": 0, "fourstep_pass2_unpack": 0}
# Launches of pass 1 in a twiddled mode (plain, packed, swap store) at
# L1 >= STAGED_MIN_L1, whose store reads W_n^{k1*j2} from the block's
# staged columns of S, by any wrapper (this module's,
# kernels/threestep_vmem.py's).
trace.COUNTS.setdefault("pass1_staged_twiddle", 0)

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


def pass1_geometry(L1: int, L2: int, width: int | None = None,
                   twiddle: bool = True) -> TileGeometry:
    """The launch of pass 1 at sides (L1, L2): W columns of length L1 per
    block, W = 16 (64-byte runs per row) where the tile stays within
    SHARED_TILE, else 8 (32-byte runs, two blocks per SM at L1 = 1024).
    `width` overrides W, for the geometry A/B of chip_smoke.py. With
    `twiddle` (every mode but the one with no twiddle) from STAGED_MIN_L1
    the shared memory holds the block's W columns of S past the planes
    (`staged_rows`)."""
    W = width or (16 if 16 * L1 <= SHARED_TILE else 8)
    if W > min(PASS1_WIDTH, L2):
        raise ValueError(f"pass 1 takes W <= {min(PASS1_WIDTH, L2)} columns; got {W}")
    geo = tile_geometry(L1, W)
    if not (twiddle and L1 >= STAGED_MIN_L1):
        return geo
    return dataclasses.replace(geo, smem=geo.smem + 8 * W * staged_rows(L1))


def pass2_geometry(L1: int, L2: int, rows: int | None = None) -> TileGeometry:
    """The launch of pass 2 at sides (L1, L2): R rows of length L2 per
    block, R = 16 where the tile stays within SHARED_TILE, else 8 (the
    store's runs of 8 consecutive k1 need R >= 8). `rows` overrides R, as
    `width` in `pass1_geometry`."""
    R = rows or (16 if 16 * L2 <= SHARED_TILE else 8)
    if R > L1:
        raise ValueError(f"pass 2 takes R <= L1 = {L1} rows; got {R}")
    return tile_geometry(L2, R)


def sandwich_geometry(L1: int, L2: int, rows: int | None = None) -> TileGeometry:
    """The launch of pass 2's sandwich mode at sides (L1, L2): R =
    SANDWICH_ROWS[L2] rows of length L2 per block in pass 2's padded tile.
    The inverse's first pass reads H in runs of run_bits(R) rows of one k2
    (csrc/fourstep.cu), and the tile's row stride is L2 + L2/16 +
    32/min(R, 8) (pass 2's at R >= 8), where each of its exchanges takes
    one wavefront per 32 floats under that slot mapping (pass 2's + 4
    would take two at R = 4; tests/test_torch_geometry.py). `rows`
    overrides R, for the A/B."""
    R = rows or SANDWICH_ROWS[L2]
    if R > L1:
        raise ValueError(f"the sandwich mode takes R <= L1 = {L1} rows; got {R}")
    geo = tile_geometry(L2, R)
    stride = L2 + L2 // 16 + 32 // min(R, 8)
    return dataclasses.replace(geo, smem=8 * R * stride, stride=stride)


def pass2_unpack_geometry(L1: int, L2: int, rows: int | None = None) -> TileGeometry:
    """The launch of pass 2's unpack mode at sides (L1, L2): R rows of
    length L2 per block, R/2 rows below L1/2 and their mirrors L1 - k1, in
    clusters of UNPACK_RUN/(R/2) blocks (csrc/fourstep.cu
    `fourstep_pass2_unpack_kernel`), in pass 2's padded tile, R =
    UNPACK_ROWS[L2]; past the planes, the staging area of the low bins (a
    re and an im plane of UNPACK_RUN rows of `unpack_pitch` floats), then
    the block's transaction barriers of the low and the high area. `rows`
    overrides R, in {8, 16} (at R = 4 a cluster would pass the 8 blocks an
    H100 takes without asking), for the sweep."""
    if L2 not in UNPACK_ROWS or L1 < 2 * UNPACK_RUN:
        raise ValueError(f"the unpack mode takes L2 in {tuple(UNPACK_ROWS)} and L1 >= "
                         f"{2 * UNPACK_RUN}; got L1 = {L1}, L2 = {L2}")
    R = rows or UNPACK_ROWS[L2]
    if R not in (8, 16):
        raise ValueError(f"the unpack mode takes R in (8, 16); got {R}")
    geo = tile_geometry(L2, R)
    return dataclasses.replace(
        geo, smem=geo.smem + 8 * UNPACK_RUN * unpack_pitch(L2, R) + UNPACK_BARRIER_BYTES)


def unpack_pitch(L2: int, R: int) -> int:
    """S, the row pitch of the unpack mode's staging areas: L2/C + 4 floats
    (C = 2*UNPACK_RUN/R blocks a cluster). A multiple of 4, so every row
    starts on 16 bytes, and 4 more than a multiple of 32, so a quarter
    warp's 16-byte reads of 8 rows of one k2 take one wavefront."""
    return L2 * R // (2 * UNPACK_RUN) + 4


def unpack_tx_bytes(L2: int, R: int) -> int:
    """The bytes that the asynchronous stores of its cluster bring each
    staging area of every block of the unpack mode, for which it arms the
    area's transaction barrier: UNPACK_BIN_BYTES for each of the UNPACK_RUN
    rows v and L2/C elements k2 it stores (csrc/fourstep.cu
    `unpack_tx_bytes`)."""
    return UNPACK_BIN_BYTES * UNPACK_RUN * (L2 * R // (2 * UNPACK_RUN))


def stage_geometry(r: int) -> TileGeometry:
    """The launch of one radix-r stage of the stage pipeline (pass 1 in its
    stage mode, pow2 r in 2..128, kernels/stage_fused.py): T = 4096/r
    transforms a block, G = T/16 batch rows of PASS1_WIDTH columns, 256
    threads. From r = 32 the engine's padded tile, its row stride
    r + r/16 + STAGE_SLACK[r]; below, one pass in registers and no shared
    memory."""
    if not (is_power_of_two(r) and 2 <= r <= 128):
        raise ValueError(f"a stage takes pow2 r in [2, 128]; got {r}")
    T = STAGE_VALUES // r
    schedule = radix_schedule(r)
    if r <= 16:
        return TileGeometry(r, T, schedule, T * r // 16, 0, 4, r)
    stride = r + r // 16 + STAGE_SLACK[r]
    return TileGeometry(r, T, schedule, T * r // 16, 8 * T * stride, 4, stride)


def leaf_geometry(leaf: int) -> TileGeometry:
    """The launch of the stage pipeline's leaf (pass 2 in its leaf mode,
    pow2 leaf in 128..2048): R = max(8, 4096/leaf) rows a block, of any
    batch rows (32 at 128: 256 threads), in pass 2's padded tile."""
    if not (is_power_of_two(leaf) and 128 <= leaf <= 2048):
        raise ValueError(f"the leaf takes pow2 leaf in [128, 2048]; got {leaf}")
    return tile_geometry(leaf, max(8, STAGE_VALUES // leaf))


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


def staged_split(L1: int) -> int:
    """U of pass 1's staged twiddle, k1 = u + U*v (csrc/fourstep.cu
    `staged_log_u`): 2^ceil(log2(L1)/2), where a block's share of S, W*(U +
    L1/U) values, is least."""
    return 1 << ((log2_int(L1) + 1) // 2)


def staged_rows(L1: int) -> int:
    """Rows of pass 1's staged table S: U + L1/U."""
    U = staged_split(L1)
    return U + L1 // U


def _staged_twiddle_np(L1: int, L2: int, direction: Direction) -> np.ndarray:
    """Pass 1's twiddle W_n^{k1*j2} split along k1 = u + U*v (U =
    `staged_split(L1)`): the (U + L1/U, L2) table S of rows S[u, j2] =
    W_n^{u*j2} and S[U + v, j2] = W_n^{U*v*j2}, in float64, so that
    W_n^{k1*j2} = S[k1 mod U, j2] * S[U + k1 div U, j2]."""
    n = L1 * L2
    U = staged_split(L1)
    j2 = np.arange(L2, dtype=np.int64)[None, :]
    k = np.concatenate([np.arange(U, dtype=np.int64), U * np.arange(L1 // U, dtype=np.int64)])
    return np.exp(2j * np.pi * float(int(direction)) / n * ((k[:, None] * j2) % n))


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
    with full_float32():
        sr = torch.matmul(Far, x3r) - torch.matmul(Fai, x3i)
        si = torch.matmul(Far, x3i) + torch.matmul(Fai, x3r)
    sr = sr.reshape(B, fa, fb, W)
    si = si.reshape(B, fa, fb, W)
    wr = twr.reshape(fa, fb, 1)
    wi = twi.reshape(fa, fb, 1)
    tr = sr * wr - si * wi
    ti = sr * wi + si * wr
    # (fb, fb) @ (B, fa, fb, W) contracts j1b -> (B, fa, k1b, W)
    with full_float32():
        yr = torch.matmul(Fbr, tr) - torch.matmul(Fbi, ti)
        yi = torch.matmul(Fbr, ti) + torch.matmul(Fbi, tr)
    return (yr.transpose(1, 2).reshape(B, L, W),
            yi.transpose(1, 2).reshape(B, L, W))


@trace.table_cache(maxsize=32)
def _plain_col_tables(L: int, direction: Direction, scale: float,
                      device: torch.device):
    tabs = _col_fft_tables(L, direction, None if scale == 1.0 else scale)
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


@trace.table_cache(maxsize=32)
def _plain_pass1_twiddle(L1: int, L2: int, direction: Direction,
                         device: torch.device):
    """W_{L1*L2}^{k1*j2} as (L1, L2) planes from pass 1's factors, rounded
    to float32 and multiplied in float32 as the kernel multiplies them:
    the rank-1 ones below STAGED_MIN_L1, S[k1 mod U, j2] * S[U + k1 div U,
    j2] from it."""
    if L1 < STAGED_MIN_L1:
        return _plain_rank1_twiddle(L1, L2, direction, device)
    S = _staged_twiddle_np(L1, L2, direction)
    Sr, Si = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (S.real, S.imag))
    U = staged_split(L1)
    k1 = torch.arange(L1, device=device)
    Br, Bi, Cr, Ci = Sr[k1 % U], Si[k1 % U], Sr[U + k1 // U], Si[U + k1 // U]
    return Br * Cr - Bi * Ci, Br * Ci + Bi * Cr


@trace.table_cache(maxsize=32)
def _plain_rank1_twiddle(L1: int, L2: int, direction: Direction,
                         device: torch.device):
    """W_{L1*L2}^{k1*j2} as (L1, L2) planes from the rank-1 factors,
    multiplied in float32 as the kernel multiplies them."""
    A, P = _rank1_twiddle_np(L1, L2, PASS1_WIDTH, direction)
    Ar, Ai, Pr, Pi = (torch.from_numpy(a.astype(np.float32)).to(device)
                      for a in (A.real, A.imag, P.real, P.imag))
    wr = Ar * Pr - Ai * Pi  # (C, L1, W)
    wi = Ar * Pi + Ai * Pr
    return (wr.permute(1, 0, 2).reshape(L1, L2),  # [k1, j2 = c*W + l]
            wi.permute(1, 0, 2).reshape(L1, L2))


def pass1_plain(xr: torch.Tensor, xi: torch.Tensor, direction, L1: int, L2: int,
                twiddle: bool = True):
    """Pass 1's math on [B, L1*L2] planes -> the (B, L1, L2) intermediate
    planes, flattened: column FFTs of length L1, times W_{L1L2}^{k1*j2}
    where `twiddle`."""
    direction = Direction(int(direction))
    B = xr.shape[0]
    fa, fb = _split_factors(L1)
    tabs = _plain_col_tables(L1, direction, 1.0, xr.device)
    yr, yi = _col_fft(xr.reshape(B, L1, L2), xi.reshape(B, L1, L2), tabs, fa, fb)
    if not twiddle:
        return yr.reshape(B, L1 * L2), yi.reshape(B, L1 * L2)
    wr, wi = _plain_pass1_twiddle(L1, L2, direction, xr.device)
    return ((yr * wr - yi * wi).reshape(B, L1 * L2),
            (yr * wi + yi * wr).reshape(B, L1 * L2))


def pass2_plain(mr: torch.Tensor, mi: torch.Tensor, direction, scale: float,
                L1: int, L2: int):
    """Pass 2's math on the (B, L1, L2) intermediate planes, flattened:
    row FFTs of length L2 times `scale`, element (k2, k1) at k2*L1 + k1."""
    direction = Direction(int(direction))
    B = mr.shape[0]
    fa, fb = _split_factors(L2)
    tabs = _plain_col_tables(L2, direction, float(scale), mr.device)
    # rows of the (L1, L2) matrix as columns: (B, L2 = j2, L1 = k1)
    yr, yi = _col_fft(mr.reshape(B, L1, L2).transpose(1, 2),
                      mi.reshape(B, L1, L2).transpose(1, 2), tabs, fa, fb)
    # (B, L2 = k2, L1 = k1) flattens to k = k2*L1 + k1
    return yr.reshape(B, L1 * L2), yi.reshape(B, L1 * L2)


def fourstep_pass1_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                         twiddle: bool = True):
    """Plain version of pass 1 on [B, n] planes -> the (B, L1, L2)
    intermediate planes, flattened to [B, n]; `twiddle=False` leaves out
    W_n^{k1*j2} (the sandwich's inverse pass 1)."""
    return pass1_plain(xr, xi, direction, *_split_sides(int(xr.shape[-1])), twiddle)


def fourstep_pass2_plain(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                         scale: float = 1.0):
    """Plain version of pass 2: intermediate [B, n] planes -> natural-order
    spectrum; `scale` is the whole output scale."""
    return pass2_plain(mr, mi, direction, scale, *_split_sides(int(mr.shape[-1])))


@trace.table_cache(maxsize=32)
def _pass1_staged_tables(L1: int, L2: int, direction: Direction, device: torch.device):
    """Pass 1's tables where it stages S (from STAGED_MIN_L1): the engine's
    twiddles of L1 and S (`_staged_twiddle_np`)."""
    return (complex_table(pass_twiddle_np(L1, direction), device),
            complex_table(_staged_twiddle_np(L1, L2, direction), device))


@trace.table_cache(maxsize=32)
def _pass1_tables(L1: int, L2: int, direction: Direction, device: torch.device):
    A, P = _rank1_twiddle_np(L1, L2, PASS1_WIDTH, direction)
    return (complex_table(pass_twiddle_np(L1, direction), device),
            complex_table(A.reshape(-1, L1), device),
            complex_table(P, device))


@trace.table_cache(maxsize=32)
def _pass2_twiddle(L2: int, direction: Direction, device: torch.device):
    return complex_table(pass_twiddle_np(L2, direction), device)


def fourstep_pass1_packed_plain(x: torch.Tensor, direction=FORWARD):
    """Plain version of `fourstep_pass1_packed`: pass 1 of the even and
    odd samples of a real [B, 2n] signal, as strided views."""
    return fourstep_pass1_plain(x[:, 0::2], x[:, 1::2], direction)


def fourstep_pass2_interleaved_plain(mr: torch.Tensor, mi: torch.Tensor,
                                     direction=FORWARD, scale: float = 1.0):
    """Plain version of `fourstep_pass2_interleaved`: pass 2, then the
    planes interleaved into a real [B, 2n] signal."""
    yr, yi = fourstep_pass2_plain(mr, mi, direction, scale)
    B, n = yr.shape
    return torch.stack([yr, yi], dim=-1).reshape(B, 2 * n)


def _check_launch(xr, xi, name: str, sides) -> tuple[int, int]:
    """Checks of a pass launch on [B, L1*L2] planes (xi None: a packed real
    row of 2*L1*L2 floats); returns `sides`, where None the two-pass
    sides of the row."""
    if xi is None:
        check_real(xr, name)
        check_cuda(xr, name=name)
        check_aligned(xr, name=name)
        if xr.shape[-1] % 2:
            raise ValueError(f"{name} takes an even length; got {tuple(xr.shape)}")
    else:
        check_planes(xr, xi, name)
        check_cuda(xr, xi, name=name)
    n = int(xr.shape[-1]) // (2 if xi is None else 1)
    if sides is None:
        if xr.dim() != 2 or not supported_large(n):
            raise ValueError(f"{name} takes [B, n] planes, pow2 n in "
                             f"[{MIN_N}, {MAX_N}]; got {tuple(xr.shape)}")
        sides = _split_sides(n)
    L1, L2 = sides
    if xr.dim() != 2 or n != L1 * L2:
        raise ValueError(f"{name} takes [B, {L1 * L2}] planes; got {tuple(xr.shape)}")
    return sides


def fourstep_pass1(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Launch pass 1 on contiguous [B, n] CUDA planes; returns the
    intermediate planes [B, n] (row-major (B, L1, L2))."""
    return _launch_pass1("fourstep_pass1", xr, xi, direction, None, LAUNCHES)


def fourstep_pass1_packed(x: torch.Tensor, direction=FORWARD):
    """Launch pass 1 on a contiguous real [B, 2n] CUDA signal (8-byte
    aligned) read as the complex [B, n] sequence (x[2j], x[2j+1]);
    returns the intermediate planes [B, n]."""
    return _launch_pass1_packed("fourstep_pass1_packed", x, direction, None, LAUNCHES)


def _pass1_step(key: str, xr, xi, direction, sides, geometry, twiddle: bool = True,
                rows: int = 1):
    """The first three phases of every pass-1 launch: the checks (B a
    multiple of `rows`), the intermediate planes, and the tables, with
    `twiddle` from STAGED_MIN_L1 S (counted in
    COUNTS["pass1_staged_twiddle"]), else A and P. Returns the phase
    marker, the planes, the pointers (tw1, A, P, S; None where not read)
    and the arguments from the batch on."""
    mark = trace.phases()
    direction = Direction(int(direction))
    L1, L2 = _check_launch(xr, xi, key, sides)
    B = xr.shape[0]
    if B % rows:
        raise ValueError(f"{key} takes a multiple of {rows} rows; got {B}")
    mark()
    mr = torch.empty(B, L1 * L2, device=xr.device)
    mi = torch.empty_like(mr)
    mark()
    geo = geometry or pass1_geometry(L1, L2, twiddle=twiddle)
    if twiddle and L1 >= STAGED_MIN_L1:
        tw1, s_tab = _pass1_staged_tables(L1, L2, direction, xr.device)
        tabs = (tw1.data_ptr(), None, None, s_tab.data_ptr())
        trace.COUNTS["pass1_staged_twiddle"] += 1
    else:
        tw1, a_tab, p_tab = _pass1_tables(L1, L2, direction, xr.device)
        tabs = (tw1.data_ptr(), a_tab.data_ptr(), p_tab.data_ptr(), None)
    return mark, mr, mi, tabs, (B, log2_int(L1), log2_int(L2), log2_int(geo.T),
                                geo.c_struct(), int(direction))


def _launch_pass1(key: str, xr, xi, direction, sides: tuple[int, int] | None,
                  counts: dict, geometry: TileGeometry | None = None):
    """Launch pass 1 (`fftlab_fourstep_pass1`) at `sides` = (L1, L2), None
    for the row's two-pass sides, on contiguous [B, L1*L2] planes, counted
    in `counts[key]`, the LAUNCHES of the wrapper's module, and recorded
    as the span `key` (`_build.launch`)."""
    mark, mr, mi, tabs, tail = _pass1_step(key, xr, xi, direction, sides, geometry)
    _build.launch("fftlab_fourstep_pass1", key, counts, xr,
                  (xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), *tabs, *tail),
                  mark)
    return mr, mi


def _launch_pass1_packed(key: str, x, direction, sides, counts: dict, geometry=None):
    """`_launch_pass1` on a real [B, 2*L1*L2] row, complex element j =
    (x[2j], x[2j+1]) (`fftlab_fourstep_pass1_packed`)."""
    mark, mr, mi, tabs, tail = _pass1_step(key, x, None, direction, sides, geometry)
    _build.launch("fftlab_fourstep_pass1_packed", key, counts, x,
                  (x.data_ptr(), mr.data_ptr(), mi.data_ptr(), *tabs, *tail), mark)
    return mr, mi


def _launch_pass1_swap(key: str, xr, xi, direction, sides, counts: dict, f1: int,
                       geometry=None):
    """`_launch_pass1` on a multiple of F1 = `f1` rows, row k1 of input row
    o*F1 + k1a stored at row (o, k1, k1a) (`fftlab_fourstep_pass1_swap`)."""
    mark, mr, mi, tabs, (B, *tail) = _pass1_step(key, xr, xi, direction, sides, geometry,
                                                 rows=f1)
    _build.launch("fftlab_fourstep_pass1_swap", key, counts, xr,
                  (xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), *tabs,
                   B // f1, log2_int(f1), *tail), mark)
    return mr, mi


def _launch_pass1_no_twiddle(key: str, xr, xi, direction, sides, counts: dict,
                             geometry=None):
    """`_launch_pass1` with no twiddle, the sandwich's inverse pass 1
    (`fftlab_fourstep_pass1_no_twiddle`)."""
    mark, mr, mi, tabs, tail = _pass1_step(key, xr, xi, direction, sides, geometry,
                                           twiddle=False)
    _build.launch("fftlab_fourstep_pass1_no_twiddle", key, counts, xr,
                  (xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), tabs[0], *tail),
                  mark)
    return mr, mi


def fourstep_pass2(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                   scale: float = 1.0):
    """Launch pass 2 on the contiguous [B, n] intermediate planes; returns
    the natural-order spectrum. `scale` is the whole output scale."""
    return _launch_pass2("fourstep_pass2", mr, mi, direction, scale, None, LAUNCHES)


def fourstep_pass2_interleaved(mr: torch.Tensor, mi: torch.Tensor,
                               direction=FORWARD, scale: float = 1.0):
    """Launch pass 2 on the contiguous [B, n] intermediate planes with
    the natural-order spectrum stored interleaved: returns the real
    [B, 2n] signal whose (2k, 2k+1) samples are bin k's (re, im)."""
    key = "fourstep_pass2_interleaved"
    mark = trace.phases()
    sides = _check_launch(mr, mi, key, None)
    mark()
    y = torch.empty(mr.shape[0], 2 * mr.shape[1], device=mr.device)
    mark()
    _build.launch("fftlab_fourstep_pass2_interleaved", key, LAUNCHES, mr,
                  _pass2_args(mr, mi, (y.data_ptr(),), direction, scale, sides, None), mark)
    return y


def _pass2_args(mr, mi, out: tuple, direction, scale: float, sides, geometry) -> tuple:
    """Pass 2's arguments with its store's pointers `out`, `geometry`
    defaulting to `pass2_geometry`."""
    L1, L2 = sides
    direction = Direction(int(direction))
    geo = geometry or pass2_geometry(L1, L2)
    return (mr.data_ptr(), mi.data_ptr(), *out,
            _pass2_twiddle(L2, direction, mr.device).data_ptr(), mr.shape[0], log2_int(L1),
            log2_int(L2), log2_int(geo.T), geo.c_struct(), int(direction), float(scale))


def _launch_pass2(key: str, mr, mi, direction, scale: float,
                  sides: tuple[int, int] | None, counts: dict,
                  geometry: TileGeometry | None = None):
    """Launch pass 2 (`fftlab_fourstep_pass2`) on contiguous [B, L1*L2]
    intermediate planes into natural-order planes; `sides`, `counts` and
    the span as in `_launch_pass1`, `geometry` as in `_pass2_args`."""
    mark = trace.phases()
    sides = _check_launch(mr, mi, key, sides)
    mark()
    yr, yi = torch.empty_like(mr), torch.empty_like(mi)
    mark()
    _build.launch("fftlab_fourstep_pass2", key, counts, mr,
                  _pass2_args(mr, mi, (yr.data_ptr(), yi.data_ptr()), direction, scale, sides,
                              geometry), mark)
    return yr, yi


def _unpack_twiddle_np(L1: int, L2: int) -> np.ndarray:
    """The unpack mode's twiddle W_n^k, n = 2*L1*L2, k = k2*L1 + k1, as
    W_n^{k1} * W_{2*L2}^{k2}: the L2 values W_{2*L2}^{k2}, then the L1/2 + 1
    values W_n^{k1} (k1 <= L1/2, the rows the kernel pairs from), in
    float64."""
    col = np.exp(-2j * np.pi * np.arange(L2, dtype=np.float64) / (2 * L2))
    row = np.exp(-2j * np.pi * np.arange(L1 // 2 + 1, dtype=np.float64) / (2 * L1 * L2))
    return np.concatenate([col, row])


@trace.table_cache(maxsize=32)
def _unpack_tables(L1: int, L2: int, device: torch.device):
    """The unpack mode's tables: the engine's forward twiddles of L2, and
    `_unpack_twiddle_np` rounded to float32."""
    return (_pass2_twiddle(L2, FORWARD, device),
            complex_table(_unpack_twiddle_np(L1, L2), device))


def fourstep_pass2_unpack(mr: torch.Tensor, mi: torch.Tensor, scale: float = 1.0):
    """Launch pass 2's unpack mode on the contiguous [B, m] intermediate
    planes of `fourstep_pass1_packed` (forward): returns the one-sided
    (re, im) [B, m+1] spectrum of the real [B, 2m] signal, bins 0..m,
    times `scale`."""
    return _launch_pass2_unpack(mr, mi, scale, LAUNCHES)


def _launch_pass2_unpack(mr, mi, scale: float, counts: dict,
                         geometry: TileGeometry | None = None):
    """Launch the unpack mode (`fftlab_fourstep_pass2_unpack`) on
    contiguous [B, L1*L2] CUDA planes; `counts` and the span as in
    `_launch_pass1`, `geometry` defaults to `pass2_unpack_geometry`."""
    key = "fourstep_pass2_unpack"
    mark = trace.phases()
    L1, L2 = _check_launch(mr, mi, key, None)
    geo = geometry or pass2_unpack_geometry(L1, L2)
    mark()
    B, m = mr.shape
    xr = torch.empty(B, m + 1, device=mr.device)
    xi = torch.empty_like(xr)
    mark()
    tw2, utw = _unpack_tables(L1, L2, mr.device)
    _build.launch("fftlab_fourstep_pass2_unpack", key, counts, mr,
                  (mr.data_ptr(), mi.data_ptr(), xr.data_ptr(), xi.data_ptr(), tw2.data_ptr(),
                   utw.data_ptr(), B, log2_int(L1), log2_int(L2), log2_int(geo.T),
                   geo.c_struct(), float(scale)), mark)
    return xr, xi


def fft_split_large(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD, *,
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


fft_split_large_ad = make_differentiable(fft_split_large)


def _half_cfft(name: str, n: int, direction):
    """The half-size complex transform of a real length-n signal: the
    two-pass kernels where n/2 fits them (2^15..2^21), else the three-pass
    kernel (2^22..2^26, kernels/threestep_vmem.py), else a ValueError
    naming both constraints (fftlab/kernels/fourstep_vmem.py:797-817)."""
    from fftlab_torch.kernels.threestep_vmem import fft_split_huge, supported_huge

    if n % 2:
        raise ValueError(f"{name} needs even n; got {n}")
    half = n // 2
    if supported_large(half):
        return lambda a, b: fft_split_large(a, b, direction)
    if not supported_huge(half):
        raise ValueError(f"{name} needs n/2 to be a power of two in "
                         f"[{MIN_N}, 2^26]; got n={n} (n/2={half})")
    return lambda a, b: fft_split_huge(a, b, direction)


def rfft_split_large(x: torch.Tensor):
    """Real-input FFT of long signals: real [..., n] -> one-sided (re, im)
    of n//2+1 bins, the half-size transform on the two-pass kernels (n/2
    pow2 in 2^15..2^21) or the three-pass kernel (n/2 in 2^22..2^26).
    Pack-two-reals, as `algos.split_stockham.rfft_split` with that
    `cfft`."""
    from fftlab_torch.algos.split_stockham import rfft_split

    check_real(x, "rfft_split_large")
    cfft = _half_cfft("rfft_split_large", int(x.shape[-1]), FORWARD)
    return rfft_split(x, cfft=cfft)


def irfft_split_large(Xr: torch.Tensor, Xi: torch.Tensor, n: int | None = None):
    """Inverse of `rfft_split_large`: one-sided (re, im) of n//2+1 bins ->
    real [..., n], 1/n scaled, the half-size inverse on the same routes."""
    from fftlab_torch.algos.split_stockham import irfft_split

    if n is None:
        n = 2 * (int(Xr.shape[-1]) - 1)
    cfft = _half_cfft("irfft_split_large", n, INVERSE)
    return irfft_split(Xr, Xi, n=n, cfft=cfft)


@trace.table_cache(maxsize=32)
def _sandwich_tables(L1: int, L2: int, device: torch.device):
    """The sandwich mode's tables: the engine's twiddles of L2 forward and
    inverse, and W_n^{-k1*j2}/n in pass 1's rank-1 form, A (L2/16, L1) and
    P (L1, 16) with 1/n folded into P (float64-built)."""
    A, P = _rank1_twiddle_np(L1, L2, PASS1_WIDTH, INVERSE)
    return (_pass2_twiddle(L2, FORWARD, device), _pass2_twiddle(L2, INVERSE, device),
            complex_table(A.reshape(-1, L1), device),
            complex_table(P / (L1 * L2), device))


def fourstep_pass2_sandwich_plain(mr: torch.Tensor, mi: torch.Tensor,
                                  hr: torch.Tensor, hi: torch.Tensor):
    """Plain version of `fourstep_pass2_sandwich` on the (B, L1, L2)
    intermediate planes, flattened to [B, n] (a new pair; the inputs are
    left as they are): the kernel's steps, each row k1's length-L2 FFT,
    times H[k2*L1 + k1], the length-L2 inverse FFT, times W_n^{-k1*j2}/n,
    row k1 at k1*L2 + j2."""
    B, n = mr.shape
    L1, L2 = _split_sides(n)
    fa, fb = _split_factors(L2)
    rows = lambda t: t.reshape(B, L1, L2).transpose(1, 2)  # (B, L2 = j2, L1 = k1)
    # (B, L2 = k2, L1 = k1): element k2*L1 + k1, H in natural order
    sr, si = _col_fft(rows(mr), rows(mi), _plain_col_tables(L2, FORWARD, 1.0, mr.device),
                      fa, fb)
    h2r, h2i = hr.reshape(L2, L1), hi.reshape(L2, L1)
    yr, yi = _col_fft(sr * h2r - si * h2i, sr * h2i + si * h2r,
                      _plain_col_tables(L2, INVERSE, 1.0, mr.device), fa, fb)
    zr, zi = yr.transpose(1, 2), yi.transpose(1, 2)  # (B, L1 = k1, L2 = j2)
    # the kernel's table products with 1/n (a power of two) folded in: exact
    wr, wi = (w / n for w in _plain_rank1_twiddle(L1, L2, INVERSE, mr.device))
    return (zr * wr - zi * wi).reshape(B, n), (zr * wi + zi * wr).reshape(B, n)


def fourstep_pass2_sandwich(mr: torch.Tensor, mi: torch.Tensor, hr: torch.Tensor,
                            hi: torch.Tensor):
    """Launch pass 2's sandwich mode on the contiguous [B, n] intermediate
    planes of the forward pass 1, IN PLACE: each row k1 of the (B, L1, L2)
    intermediate becomes W_n^{-k1*j2}/n * IFFT(FFT(row) * H[k2*L1 + k1]),
    the input of the inverse's pass 1. H: contiguous float32 CUDA planes of
    n bins in natural order. Returns (mr, mi)."""
    return _launch_sandwich(mr, mi, hr, hi, LAUNCHES)


def _launch_sandwich(mr, mi, hr, hi, counts: dict, geometry: TileGeometry | None = None):
    """Launch the sandwich mode (`fftlab_fourstep_pass2_sandwich`) in place
    on contiguous [B, n] CUDA planes; `counts` as in `_launch_pass1`,
    `geometry` defaults to `sandwich_geometry`."""
    key = "fourstep_pass2_sandwich"
    mark = trace.phases()
    L1, L2 = _check_launch(mr, mi, key, None)
    check_cuda(hr, hi, name=key)
    check_response(hr, hi, L1 * L2, mr, key)
    mark(2)  # in place: nothing to allocate
    geo = geometry or sandwich_geometry(L1, L2)
    tw_fwd, tw_inv, a_tab, p_tab = _sandwich_tables(L1, L2, mr.device)
    _build.launch("fftlab_fourstep_pass2_sandwich", key, counts, mr,
                  (mr.data_ptr(), mi.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(),
                   hr.data_ptr(), hi.data_ptr(), a_tab.data_ptr(), p_tab.data_ptr(),
                   mr.shape[0], log2_int(L1), log2_int(L2), log2_int(geo.T), geo.c_struct()),
                  mark)
    return mr, mi


def spectral_filter_large_plain(xr: torch.Tensor, xi: torch.Tensor,
                                hr: torch.Tensor, hi: torch.Tensor):
    """Plain version of the three-launch sandwich on [B, n] planes: pass 1,
    the sandwich mode, the inverse pass 1 with no twiddle."""
    mr, mi = fourstep_pass1_plain(xr, xi, FORWARD)
    return fourstep_pass1_plain(*fourstep_pass2_sandwich_plain(mr, mi, hr, hi), INVERSE,
                                twiddle=False)


def _filter_launches(xr, xi, hr, hi):
    mr, mi = fourstep_pass1(xr, xi, FORWARD)
    fourstep_pass2_sandwich(mr, mi, hr, hi)
    return _launch_pass1_no_twiddle("fourstep_pass1", mr, mi, INVERSE, None, LAUNCHES)


def spectral_filter_large(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """ifft(fft(x) * H), 1/n scaled, on split planes [..., n], pow2 n in
    2^15..2^21: the three launches for a CUDA tensor, the plain version for
    a CPU tensor. hr, hi: the n-bin response in natural order (numpy or
    tensor)."""
    check_planes(xr, xi, "spectral_filter_large")
    n = int(xr.shape[-1])
    if not supported_large(n):
        raise ValueError(
            f"spectral_filter_large supports pow2 n in [{MIN_N}, {MAX_N}]; got {n}")
    hr, hi = response_planes(hr, hi, xr)
    B = rows_of(xr.shape)
    run = (spectral_filter_large_plain if on_cpu(xr, "spectral_filter_large")
           else _filter_launches)
    yr, yi = run(xr.reshape(B, n), xi.reshape(B, n), hr, hi)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)
