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
kernel's math in tensor ops with the same tables,
the length-L FFT as the fa*fb contraction pair of `_col_fft_vmem` and
the pass-1 twiddle in the rank-1 form A[c, k1]*P[k1, l] of
`_rank1_twiddle_np`. Forward unscaled, inverse 1/n; `scale` multiplies
the output on top and is folded into pass 2 only. `fft_split_large_ad`
is `fft_split_large` with its adjoint for autograd (kernels/_ad.py;
fftlab/kernels/fourstep_vmem.py:858).

The real-signal modes fuse K7's pack and interleave into the passes:
`fourstep_pass1_packed` reads a real [B, 2n] row as float2 pairs,
complex element j = (x[2j], x[2j+1]), and `fourstep_pass2_interleaved`
stores bin k as the float2 (y[2k], y[2k+1]) of a real [B, 2n] row; they
make the fused r2c/c2r of kernels/rfft_resident.py. `rfft_split_large`
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
    stream_of,
    tile_geometry,
)
from fftlab_torch.utils import trace

MIN_N = 1 << 15
MAX_N = 1 << 21

# Columns of the pass-1 rank-1 twiddle tables (csrc/fourstep.cu
# kLogTableWidth): a pass-1 block of W <= 16 columns reads its part.
PASS1_WIDTH = 16
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

# Launches of the CUDA kernels since the counts were last reset.
LAUNCHES = {"fourstep_pass1": 0, "fourstep_pass2": 0,
            "fourstep_pass2_sandwich": 0, "fourstep_pass1_packed": 0,
            "fourstep_pass2_interleaved": 0}

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


def pass1_geometry(L1: int, L2: int, width: int | None = None) -> TileGeometry:
    """The launch of pass 1 at sides (L1, L2): W columns of length L1 per
    block, W = 16 (64-byte runs per row) where the tile stays within
    SHARED_TILE, else 8 (32-byte runs, two blocks per SM at L1 = 1024).
    `width` overrides W, for the geometry A/B of chip_smoke.py."""
    W = width or (16 if 16 * L1 <= SHARED_TILE else 8)
    if W > min(PASS1_WIDTH, L2):
        raise ValueError(f"pass 1 takes W <= {min(PASS1_WIDTH, L2)} columns; got {W}")
    return tile_geometry(L1, W)


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


def _two_pass_sides(x, name: str, n: int | None = None) -> tuple[int, int]:
    """Sides (L1, L2) of a two-pass launch on [B, n] planes, after the
    window check; `n` is the complex length (half a real row's)."""
    n = int(x.shape[-1]) if n is None else n
    if x.dim() != 2 or not supported_large(n):
        raise ValueError(f"{name} takes [B, n] planes, pow2 n in "
                         f"[{MIN_N}, {MAX_N}]; got {tuple(x.shape)}")
    return _split_sides(n)


def _check_launch(xr, xi, name: str, sides: tuple[int, int]) -> None:
    """Checks of a pass launch on [B, L1*L2] planes; for a real row, xi is
    None and the row holds 2*L1*L2 floats."""
    if xi is None:
        check_real(xr, name)
        check_cuda(xr, name=name)
        check_aligned(xr, name=name)
    else:
        check_planes(xr, xi, name)
        check_cuda(xr, xi, name=name)
    L1, L2 = sides
    n = int(xr.shape[-1]) // (2 if xi is None else 1)
    if xr.dim() != 2 or n != L1 * L2:
        raise ValueError(f"{name} takes [B, {L1 * L2}] planes; got {tuple(xr.shape)}")


def fourstep_pass1(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Launch pass 1 on contiguous [B, n] CUDA planes; returns the
    intermediate planes [B, n] (row-major (B, L1, L2))."""
    return _launch_pass1("fourstep_pass1", xr, xi, direction, None, LAUNCHES)


def fourstep_pass1_packed(x: torch.Tensor, direction=FORWARD):
    """Launch pass 1 on a contiguous real [B, 2n] CUDA signal (8-byte
    aligned) read as the complex [B, n] sequence (x[2j], x[2j+1]);
    returns the intermediate planes [B, n]."""
    if x.shape[-1] % 2:
        raise ValueError(f"fourstep_pass1_packed takes an even length; got "
                         f"{tuple(x.shape)}")
    return _launch_pass1("fourstep_pass1_packed", x, None, direction, None, LAUNCHES)


def _launch_pass1(name: str, xr, xi, direction, sides: tuple[int, int] | None,
                  counts: dict, swap: int = 1, geometry: TileGeometry | None = None,
                  twiddle: bool = True):
    """Launch pass 1 at `sides` = (L1, L2) on contiguous [B, L1*L2] planes
    (xi None: a packed real row; `sides` None: the two-pass sides of the
    row); `swap` = F1 > 1 launches the swap-store
    mode (`fftlab_fourstep_pass1_swap`): row k1 of input row o*F1 + k1a is
    stored at row (o, k1, k1a). `geometry` defaults to `pass1_geometry`;
    `twiddle` False (planes, no swap) launches the mode with no twiddle
    (`fftlab_fourstep_pass1_no_twiddle`). The launch adds one to
    `counts[name]`, the LAUNCHES of the module whose wrapper it serves,
    and, while the recorder is on, records its span `name` with the
    phases checks, alloc, tables and call (utils/trace.py)."""
    rec = trace.on()
    t0 = rec and trace.now()
    direction = Direction(int(direction))
    packed = xi is None
    if sides is None:
        sides = _two_pass_sides(xr, name, int(xr.shape[-1]) // 2 if packed else None)
    _check_launch(xr, xi, name, sides)
    L1, L2 = sides
    B = xr.shape[0]
    if B % swap:
        raise ValueError(f"{name} takes a multiple of {swap} rows; got {B}")
    t1 = rec and trace.now()
    mr = torch.empty(B, L1 * L2, device=xr.device)
    mi = torch.empty_like(mr)
    t2 = rec and trace.now()
    geo = geometry or pass1_geometry(L1, L2)
    tw1, a_tab, p_tab = _pass1_tables(L1, L2, direction, xr.device)
    tabs = (tw1.data_ptr(), a_tab.data_ptr(), p_tab.data_ptr())
    logs = (log2_int(L1), log2_int(L2), log2_int(geo.T), geo.c_struct())
    t3 = rec and trace.now()
    lib = _build.load_library()
    tail = (int(direction), stream_of(xr))
    with torch.cuda.device(xr.device):
        if packed:
            rc = lib.fftlab_fourstep_pass1_packed(xr.data_ptr(), mr.data_ptr(),
                                                  mi.data_ptr(), *tabs, B, *logs, *tail)
        elif swap > 1:
            rc = lib.fftlab_fourstep_pass1_swap(
                xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), *tabs,
                B // swap, log2_int(swap), *logs, *tail)
        elif not twiddle:
            rc = lib.fftlab_fourstep_pass1_no_twiddle(
                xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), tabs[0], B, *logs,
                *tail)
        else:
            rc = lib.fftlab_fourstep_pass1(xr.data_ptr(), xi.data_ptr(), mr.data_ptr(),
                                           mi.data_ptr(), *tabs, B, *logs, *tail)
    _build.check(lib, name, rc)
    counts[name] += 1
    if rec:
        trace.launch(name, t0, t1, t2, t3, trace.now())
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
    return _launch_pass2("fourstep_pass2_interleaved", mr, mi, direction, scale, None,
                         LAUNCHES)


def _launch_pass2(name: str, mr, mi, direction, scale: float,
                  sides: tuple[int, int] | None, counts: dict,
                  geometry: TileGeometry | None = None):
    """Launch pass 2 (the store of `name`) on contiguous [B, L1*L2]
    intermediate planes; `sides`, `counts` and the span as in
    `_launch_pass1`, `geometry` defaults to `pass2_geometry`."""
    rec = trace.on()
    t0 = rec and trace.now()
    direction = Direction(int(direction))
    if sides is None:
        sides = _two_pass_sides(mr, name)
    _check_launch(mr, mi, name, sides)
    L1, L2 = sides
    n = L1 * L2
    interleaved = name == "fourstep_pass2_interleaved"
    t1 = rec and trace.now()
    if interleaved:
        out = torch.empty(mr.shape[0], 2 * n, device=mr.device)
    else:
        out = (torch.empty_like(mr), torch.empty_like(mi))
    t2 = rec and trace.now()
    tw2 = _pass2_twiddle(L2, direction, mr.device)
    geo = geometry or pass2_geometry(L1, L2)
    args = (mr.shape[0], log2_int(L1), log2_int(L2), log2_int(geo.T), geo.c_struct(),
            int(direction), float(scale))
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(mr.device):
        if interleaved:
            rc = lib.fftlab_fourstep_pass2_interleaved(
                mr.data_ptr(), mi.data_ptr(), out.data_ptr(), tw2.data_ptr(), *args,
                stream_of(mr))
        else:
            rc = lib.fftlab_fourstep_pass2(
                mr.data_ptr(), mi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                tw2.data_ptr(), *args, stream_of(mr))
    _build.check(lib, name, rc)
    counts[name] += 1
    if rec:
        trace.launch(name, t0, t1, t2, t3, trace.now())
    return out


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
    wr, wi = (w / n for w in _plain_pass1_twiddle(L1, L2, INVERSE, mr.device))
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
    """Launch the sandwich mode in place on contiguous [B, n] CUDA planes;
    `counts` as in `_launch_pass1`, `geometry` defaults to
    `sandwich_geometry`."""
    rec = trace.on()
    t0 = rec and trace.now()
    name = "fourstep_pass2_sandwich"
    sides = _two_pass_sides(mr, name)
    _check_launch(mr, mi, name, sides)
    check_cuda(hr, hi, name=name)
    L1, L2 = sides
    check_response(hr, hi, L1 * L2, mr, name)
    t1 = rec and trace.now()  # in place: nothing to allocate
    geo = geometry or sandwich_geometry(L1, L2)
    tabs = _sandwich_tables(L1, L2, mr.device)
    args = (*(t.data_ptr() for t in tabs[2:]), mr.shape[0], log2_int(L1), log2_int(L2),
            log2_int(geo.T), geo.c_struct())
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(mr.device):
        rc = lib.fftlab_fourstep_pass2_sandwich(
            mr.data_ptr(), mi.data_ptr(), *(t.data_ptr() for t in tabs[:2]), hr.data_ptr(),
            hi.data_ptr(), *args, stream_of(mr))
    _build.check(lib, name, rc)
    counts[name] += 1
    if rec:
        trace.launch(name, t0, t1, t1, t3, trace.now())
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
    return _launch_pass1("fourstep_pass1", mr, mi, INVERSE, None, LAUNCHES, twiddle=False)


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
