"""One radix-r Cooley-Tukey stage with its twiddle fused in, and the FFT
built from such stages: the `stage_pipeline` route (counterpart of
fftlab/kernels/stage_fused.py).

`fused_stage` views x [B, n] as (B, r, M), n = r*M, contracts the leading
digit j against F_r and multiplies the stage twiddle W_n^{k*m}
(`stage_twiddle_np`), or no twiddle:

    out[b, k*M + m] = W_n^{k*m} * sum_j F_r[k, j] * x[b, j*M + m].

That is pass 1 of the two-pass FFT at (L1, L2) = (r, M). On a CUDA tensor
`fused_stage` launches `fourstep_pass1_kernel` in its stage mode
(csrc/fourstep.cu, on the register engine of csrc/fft_reg.cuh) with the
tables of `fourstep_vmem._pass1_tables(r, M)`, or A and P of ones for no
twiddle, at the launch of `fourstep_vmem.stage_geometry`. On a CPU tensor
the plain version runs: the JAX kernel's math in tensor ops, the
contraction with `dft_matrix_np(r)` and the whole (r, M) stage twiddle.
The kernel takes pow2 r in 2..128 and, as the JAX kernel's layout does,
M % 128 == 0.

`fft_split_pipeline` is K-1 stages (each produced digit folds into the
batch) and a leaf of length factors[-1]. On CUDA tensors that is K
launches and nothing else:

  stage 1      `fused_stage`, pass 1's plain store;
  stage i > 1  `swap_stage`, pass 1's swap store with F1 = r_1*...*r_{i-1}:
               output row k of input row o*F1 + k1a goes to row
               (o, k, k1a), so the rows reach the leaf in the order
               (k_{K-1}, ..., k_1);
  leaf         `stage_leaf`, pass 2 in its leaf mode at (n/leaf, leaf):
               the length-leaf FFT of every row, element k_K of row rho
               stored at k_K*(n/leaf) + rho, which is the natural order
               (the digit reversal rides the store); the inverse's 1/n
               and the caller's `scale` ride its last pass.

At 2^21 the factors (128, 128, 128) are the three-pass FFT's sides, and
the launches are its passes A, B and C. On CPU tensors
`fft_split_pipeline` runs `fft_split_pipeline_plain`, the JAX package's
math: the plain stages, the leaf contraction as a float32 `torch.matmul`
and the digit reversal as a `permute`. `pipeline_launches_plain` is the
card's launch sequence with each launch's plain version
(`fused_stage_plain`, `swap_stage_plain`, `stage_leaf_plain`).

The JAX kernel's `col_tile` (column tiles per TPU program) has no
counterpart: a stage's block takes 4096 values, 256/r rows of 16 columns
(`stage_geometry`).
"""

from __future__ import annotations


import numpy as np
import torch

from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two, log2_int
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (check_cuda, check_planes, complex_table,
                                          effective_scale, on_cpu, stream_of)
from fftlab_torch.kernels.fourstep_vmem import (PASS1_WIDTH, _pass1_tables, _pass2_twiddle,
                                                leaf_geometry, stage_geometry)
from fftlab_torch.utils import trace

LANES = 128
MAX_RADIX = 128
# The longest leaf the leaf kernel takes (pass 2's lengths, 128..2048).
MAX_LEAF = 2048

# Launches of the CUDA kernels since the counts were last reset: the
# stages (plain and swap store) and the leaf.
LAUNCHES = {"fused_stage": 0, "stage_leaf": 0}


def _check_stage(xr, xi, r: int, name: str) -> int:
    """[B, n] float32 planes with n = r*M, M % 128 == 0; returns M."""
    check_planes(xr, xi, name)
    n = int(xr.shape[-1])
    if xr.dim() != 2 or r < 2 or n % r or (n // r) % LANES:
        raise ValueError(f"{name} takes [B, r*M] planes with M % {LANES} == 0; "
                         f"got {tuple(xr.shape)} at r={r}")
    return n // r


@trace.table_cache(maxsize=64)
def _plain_tables(r: int, M: int, direction: Direction, twiddle: bool,
                  device: torch.device):
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.float32)).to(device)
    F = dft_matrix_np(r, direction)
    tw = stage_twiddle_np(r, M, direction) if twiddle else None
    return (as_t(F.real), as_t(F.imag),
            None if tw is None else as_t(tw.real), None if tw is None else as_t(tw.imag))


def fused_stage_plain(xr: torch.Tensor, xi: torch.Tensor, r: int, direction=FORWARD,
                      twiddle: bool = True):
    """Plain version of `fused_stage` on [B, r*M] planes."""
    direction = Direction(int(direction))
    B, n = xr.shape
    M = n // r
    Fr, Fi, twr, twi = _plain_tables(r, M, direction, bool(twiddle), xr.device)
    x3r = xr.reshape(B, r, M)
    x3i = xi.reshape(B, r, M)
    with full_float32():
        yr = torch.matmul(Fr, x3r) - torch.matmul(Fi, x3i)
        yi = torch.matmul(Fr, x3i) + torch.matmul(Fi, x3r)
    if twiddle:
        yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
    return yr.reshape(B, n), yi.reshape(B, n)


def swap_stage_plain(xr: torch.Tensor, xi: torch.Tensor, r: int, f1: int,
                     direction=FORWARD):
    """Plain version of `swap_stage` on [rows, r*M] planes, rows =
    o*F1 + k1a: the stage's plain version, then output row (o, k1a, k)
    moved to (o, k, k1a)."""
    yr, yi = fused_stage_plain(xr, xi, r, direction)
    rows, n = xr.shape
    swap = lambda t: t.reshape(rows // f1, f1, r, n // r).transpose(1, 2).reshape(rows, n)
    return swap(yr), swap(yi)


@trace.table_cache(maxsize=32)
def _leaf_table(r: int, direction: Direction, scale: float, device: torch.device):
    F = dft_matrix_np(r, direction) * scale
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T).astype(np.float32)).to(device)
    return as_t(F.real), as_t(F.imag)


def _leaf_contraction(xr, xi, leaf: int, direction: Direction, scale: float):
    """Rows of length `leaf` times F_leaf*scale (float32 matmul)."""
    Fr, Fi = _leaf_table(leaf, direction, float(scale), xr.device)
    a_r = xr.reshape(-1, leaf)
    a_i = xi.reshape(-1, leaf)
    with full_float32():
        return (torch.matmul(a_r, Fr) - torch.matmul(a_i, Fi),
                torch.matmul(a_r, Fi) + torch.matmul(a_i, Fr))


def stage_leaf_plain(xr: torch.Tensor, xi: torch.Tensor, leaf: int, direction=FORWARD,
                     scale: float = 1.0):
    """Plain version of `stage_leaf` on [B, n] planes of n/leaf rows of
    length `leaf`: the leaf contraction, then element k of row rho stored
    at k*(n/leaf) + rho."""
    B, n = xr.shape
    yr, yi = _leaf_contraction(xr, xi, leaf, Direction(int(direction)), scale)
    turn = lambda t: t.reshape(B, n // leaf, leaf).transpose(1, 2).reshape(B, n)
    return turn(yr), turn(yi)


@trace.table_cache(maxsize=64)
def _stage_tables(r: int, M: int, direction: Direction, twiddle: bool, device: torch.device):
    tw1, a_tab, p_tab = _pass1_tables(r, M, direction, device)
    if not twiddle:  # W^0: the rank-1 factors of a twiddle of ones
        a_tab = complex_table(np.ones((M // PASS1_WIDTH, r)), device)
        p_tab = complex_table(np.ones((r, PASS1_WIDTH)), device)
    return tw1, a_tab, p_tab


def _launch(xr, xi, r: int, direction: Direction, twiddle: bool, f1: int):
    """Launch one stage on contiguous [rows, r*M] CUDA planes: pass 1 in
    its stage mode, output row k of input row o*f1 + k1a at row
    (o, k, k1a) (f1 = 1: the plain store)."""
    rec = trace.on()
    t0 = rec and trace.now()
    name = "fused_stage"
    check_cuda(xr, xi, name=name)
    rows, n = xr.shape
    M = n // r
    if not (is_power_of_two(r) and r <= MAX_RADIX and is_power_of_two(M)):
        raise ValueError(f"the {name} kernel takes pow2 r in [2, {MAX_RADIX}] and pow2 M; "
                         f"got r={r}, M={M}")
    geo = stage_geometry(r)
    tw1, a_tab, p_tab = _stage_tables(r, M, direction, bool(twiddle), xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_fused_stage(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw1.data_ptr(),
            a_tab.data_ptr(), p_tab.data_ptr(), rows, log2_int(f1), log2_int(r), log2_int(M),
            log2_int(geo.T // PASS1_WIDTH), geo.c_struct(), int(direction), stream_of(xr))
    _build.check(lib, name, rc)
    LAUNCHES[name] += 1
    if rec:
        trace.launch_call(name, t0, t3, trace.now())
    return yr, yi


def fused_stage(xr: torch.Tensor, xi: torch.Tensor, r: int, direction=FORWARD,
                twiddle: bool = True):
    """One radix-r stage over the leading digit of [B, r*M] planes, times
    the stage twiddle (or none): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns [B, n], k-major."""
    direction = Direction(int(direction))
    _check_stage(xr, xi, r, "fused_stage")
    if on_cpu(xr, "fused_stage"):
        return fused_stage_plain(xr, xi, r, direction, twiddle)
    return _launch(xr, xi, r, direction, twiddle, 1)


def swap_stage(xr: torch.Tensor, xi: torch.Tensor, r: int, f1: int, direction=FORWARD):
    """The stage with its twiddle on [rows, r*M] planes, rows = o*F1 + k1a,
    output row k of input row (o, k1a) stored at row (o, k, k1a): the
    stages after the first of the pipeline. The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    direction = Direction(int(direction))
    _check_stage(xr, xi, r, "swap_stage")
    if not is_power_of_two(f1) or xr.shape[0] % f1:
        raise ValueError(f"swap_stage takes a multiple of pow2 F1 = {f1} rows; "
                         f"got {xr.shape[0]}")
    if on_cpu(xr, "swap_stage"):
        return swap_stage_plain(xr, xi, r, f1, direction)
    return _launch(xr, xi, r, direction, True, f1)


def stage_leaf(xr: torch.Tensor, xi: torch.Tensor, leaf: int, direction=FORWARD,
               scale: float = 1.0):
    """The pipeline's leaf on [B, n] planes of n/leaf rows of length
    `leaf`: the FFT of every row times `scale`, element k of row rho
    stored at k*(n/leaf) + rho. The CUDA kernel (pass 2 in its leaf mode,
    pow2 leaf in 128..2048) for a CUDA tensor, the plain version for a CPU
    tensor."""
    name = "stage_leaf"
    check_planes(xr, xi, name)
    if xr.dim() != 2 or leaf < 1 or xr.shape[-1] % leaf:
        raise ValueError(f"{name} takes [B, n] planes of rows of length {leaf}; "
                         f"got {tuple(xr.shape)}")
    B, n = xr.shape
    direction = Direction(int(direction))
    if on_cpu(xr, name):
        return stage_leaf_plain(xr, xi, leaf, direction, scale)
    rec = trace.on()
    t0 = rec and trace.now()
    check_cuda(xr, xi, name=name)
    if not (is_power_of_two(n) and LANES <= leaf <= MAX_LEAF):
        raise ValueError(f"the {name} kernel takes pow2 n and pow2 leaf in "
                         f"[{LANES}, {MAX_LEAF}]; got n={n}, leaf={leaf}")
    geo = leaf_geometry(leaf)
    tw2 = _pass2_twiddle(leaf, direction, xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_stage_leaf(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw2.data_ptr(), B,
            log2_int(n // leaf), log2_int(leaf), log2_int(geo.T), geo.c_struct(),
            int(direction), float(scale), stream_of(xr))
    _build.check(lib, name, rc)
    LAUNCHES[name] += 1
    if rec:
        trace.launch_call(name, t0, t3, trace.now())
    return yr, yi


def pipeline_factors(n: int) -> tuple[int, ...]:
    """Factorization of pow2 n for the pipeline: greedy radices of at
    most 128 that leave M = remaining/r divisible by 128 at every fused
    stage, and a leaf of whatever <= 128 remains."""
    if n < 2 * LANES or n & (n - 1):
        raise ValueError(f"pipeline needs pow2 n >= {2 * LANES}; got {n}")
    fs = []
    rem = n
    while rem > LANES:
        r = min(LANES, rem // LANES)
        fs.append(r)
        rem //= r
    fs.append(rem)
    return tuple(fs)


def _check_factors(xr, xi, factors) -> None:
    check_planes(xr, xi, "fft_split_pipeline")
    n = int(xr.shape[-1])
    if int(np.prod(factors)) != n:
        raise ValueError(f"factors {tuple(factors)} do not multiply to n={n}")
    rem = n
    for r in factors[:-1]:
        if (rem // r) % LANES:
            raise ValueError(
                f"stage radix {r} leaves M={rem // r} columns; the fused stage needs "
                f"M % {LANES} == 0 - reorder factors (small radices first)")
        rem //= r


def _launch_sequence(xr, xi, direction, factors, scale, stage, swap, leaf):
    """The card's K launches: `stage`, then `swap` with F1 = r_1*...*r_{i-1}
    for the later stages, then `leaf` with the whole output scale."""
    direction = Direction(int(direction))
    _check_factors(xr, xi, factors)
    B, n = xr.shape
    f1, rem = 1, n
    for r in factors[:-1]:
        ar, ai = xr.reshape(B * f1, rem), xi.reshape(B * f1, rem)
        xr, xi = stage(ar, ai, r, direction) if f1 == 1 else swap(ar, ai, r, f1, direction)
        f1 *= r
        rem //= r
    return leaf(xr.reshape(B, n), xi.reshape(B, n), factors[-1], direction,
                effective_scale(n, direction, scale))


def pipeline_launches_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                            factors=(64, 128, 128), scale: float | None = None):
    """The launch sequence of `fft_split_pipeline` on the card, each launch
    by its plain version, on any device: the stage, the swap stages and
    the leaf pass."""
    return _launch_sequence(xr, xi, direction, factors, scale, fused_stage_plain,
                            swap_stage_plain, stage_leaf_plain)


def fft_split_pipeline_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                             factors=(64, 128, 128), *, scale: float | None = None):
    """The JAX package's pipeline in tensor ops, on any device: K-1 plain
    stages (each produced digit folds into the batch), the leaf
    contraction (`torch.matmul`, float32) and the digit reversal (a
    `permute`). Forward unscaled / inverse 1/n; `scale` multiplies on
    top, folded into the leaf's table."""
    direction = Direction(int(direction))
    _check_factors(xr, xi, factors)
    B, n = xr.shape
    rem, bfold = n, B
    for r in factors[:-1]:
        xr, xi = fused_stage_plain(xr.reshape(bfold, rem), xi.reshape(bfold, rem), r,
                                   direction)
        bfold *= r
        rem //= r
    yr, yi = _leaf_contraction(xr, xi, factors[-1], direction,
                               effective_scale(n, direction, scale))
    perm = (0,) + tuple(range(len(factors), 0, -1))
    yr = yr.reshape(B, *factors).permute(perm).reshape(B, n)
    yi = yi.reshape(B, *factors).permute(perm).reshape(B, n)
    return yr, yi


def fft_split_pipeline(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                       factors=(64, 128, 128), *, scale: float | None = None):
    """FFT of [B, n] planes from fused stages: on CUDA planes K launches
    (`fused_stage`, `swap_stage` for the later stages, `stage_leaf`), on
    CPU planes `fft_split_pipeline_plain`. Forward unscaled / inverse 1/n;
    `scale` multiplies on top, folded into the leaf. `scale` is
    keyword-only: the JAX function's 5th parameter is `col_tile`."""
    check_planes(xr, xi, "fft_split_pipeline")
    if on_cpu(xr, "fft_split_pipeline"):
        return fft_split_pipeline_plain(xr, xi, direction, factors, scale=scale)
    # what no kernel runs raises before the first launch
    if not all(is_power_of_two(r) and r <= MAX_RADIX for r in factors[:-1]):
        raise ValueError(f"the fused_stage kernel takes pow2 r in [2, {MAX_RADIX}]; "
                         f"got factors {tuple(factors)}")
    if not (is_power_of_two(factors[-1]) and LANES <= factors[-1] <= MAX_LEAF):
        raise ValueError(f"the stage_leaf kernel takes pow2 leaf in [{LANES}, {MAX_LEAF}]; "
                         f"got factors {tuple(factors)}")
    return _launch_sequence(xr, xi, direction, factors, scale, fused_stage, swap_stage,
                            stage_leaf)
