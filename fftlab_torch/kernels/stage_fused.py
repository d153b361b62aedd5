"""One radix-r Cooley-Tukey stage with its twiddle fused in, and the FFT
built from such stages: the `stage_pipeline` route (counterpart of
fftlab/kernels/stage_fused.py).

`fused_stage` views x [B, n] as (B, r, M), n = r*M, contracts the leading
digit j against F_r and multiplies the stage twiddle W_n^{k*m}
(`stage_twiddle_np`), or no twiddle:

    out[b, k*M + m] = W_n^{k*m} * sum_j F_r[k, j] * x[b, j*M + m].

On a CUDA tensor the hand-written kernel `fused_stage`
(csrc/stage_fused.cu) runs: the length-r FFT down columns in shared
memory, the twiddle in rank-1 form from float64-built tables, one read
and one write of the signal. On a CPU tensor the plain version runs: the
JAX kernel's math in tensor ops, the contraction with `dft_matrix_np(r)`
and the whole (r, M) `stage_twiddle_np` table. The kernel takes pow2 r in
2..128 and, as the JAX kernel's layout does, M % 128 == 0.

`fft_split_pipeline` chains K-1 fused stages (each produced digit folds
into the batch), then the leaf contraction and the digit reversal, which
the JAX package computes outside any Pallas kernel: here a float32
`torch.matmul` and a `permute`. The inverse's 1/n and the caller's
`scale` ride the leaf's DFT table.

The JAX kernel's `col_tile` (column tiles per TPU program) has no
counterpart: the CUDA kernel sizes its own tile of 4096 values from r
and M (csrc/stage_fused.cu).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import FORWARD, Direction, is_power_of_two, log2_int
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (check_cuda, check_planes, complex_table,
                                          effective_scale, on_cpu, stream_of, twiddle_np)
from fftlab_torch.kernels.fourstep_vmem import _rank1_twiddle_np

LANES = 128
# Values of one kernel tile (r * columns * rows), csrc/stage_fused.cu.
STAGE_TILE = 4096
MAX_RADIX = 128

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"fused_stage": 0}


def _check_stage(xr, xi, r: int, name: str) -> int:
    """[B, n] float32 planes with n = r*M, M % 128 == 0; returns M."""
    check_planes(xr, xi, name)
    n = int(xr.shape[-1])
    if xr.dim() != 2 or r < 2 or n % r or (n // r) % LANES:
        raise ValueError(f"{name} takes [B, r*M] planes with M % {LANES} == 0; "
                         f"got {tuple(xr.shape)} at r={r}")
    return n // r


@functools.lru_cache(maxsize=64)
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


def _stage_tile(r: int, M: int) -> tuple[int, int]:
    """(T, G): columns and batch rows per kernel block, r*T*G = STAGE_TILE
    values: T = STAGE_TILE/r clamped to [32, M], G rows fill the rest."""
    T = min(M, max(32, STAGE_TILE // r))
    return T, max(1, STAGE_TILE // (r * T))


@functools.lru_cache(maxsize=64)
def _kernel_tables(r: int, M: int, direction: Direction, device: torch.device):
    T, _ = _stage_tile(r, M)
    A, P = _rank1_twiddle_np(r, M, T, direction)
    return (complex_table(twiddle_np(r, direction), device),
            complex_table(A.reshape(-1, r), device), complex_table(P, device))


def _launch(xr, xi, r: int, direction: Direction, twiddle: bool, M: int):
    check_cuda(xr, xi, name="fused_stage")
    if not (is_power_of_two(r) and r <= MAX_RADIX):
        raise ValueError(f"the fused_stage kernel takes pow2 r in [2, {MAX_RADIX}]; got {r}")
    T, G = _stage_tile(r, M)
    lib = _build.load_library()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tw, a_tab, p_tab = _kernel_tables(r, M, direction, xr.device)
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_fused_stage(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw.data_ptr(),
            a_tab.data_ptr(), p_tab.data_ptr(), xr.shape[0], log2_int(r), log2_int(M),
            log2_int(T), log2_int(G), int(direction), int(bool(twiddle)), stream_of(xr))
    _build.check(lib, "fused_stage", rc)
    LAUNCHES["fused_stage"] += 1
    return yr, yi


def fused_stage(xr: torch.Tensor, xi: torch.Tensor, r: int, direction=FORWARD,
                twiddle: bool = True):
    """One radix-r stage over the leading digit of [B, r*M] planes, times
    the stage twiddle (or none): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns [B, n], k-major."""
    direction = Direction(int(direction))
    M = _check_stage(xr, xi, r, "fused_stage")
    if on_cpu(xr, "fused_stage"):
        return fused_stage_plain(xr, xi, r, direction, twiddle)
    return _launch(xr, xi, r, direction, twiddle, M)


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


@functools.lru_cache(maxsize=32)
def _leaf_table(r: int, direction: Direction, scale: float, device: torch.device):
    F = dft_matrix_np(r, direction) * scale
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T).astype(np.float32)).to(device)
    return as_t(F.real), as_t(F.imag)


def _pipeline(xr, xi, direction, factors, scale, stage):
    direction = Direction(int(direction))
    check_planes(xr, xi, "fft_split_pipeline")
    B, n = xr.shape
    if int(np.prod(factors)) != n:
        raise ValueError(f"factors {tuple(factors)} do not multiply to n={n}")
    rem, bfold = n, B
    for r in factors[:-1]:
        if (rem // r) % LANES:
            raise ValueError(
                f"stage radix {r} leaves M={rem // r} columns; the fused stage needs "
                f"M % {LANES} == 0 - reorder factors (small radices first)")
        xr, xi = stage(xr.reshape(bfold, rem), xi.reshape(bfold, rem), r, direction)
        bfold *= r
        rem //= r
    r = factors[-1]
    Fr, Fi = _leaf_table(r, direction, effective_scale(n, direction, scale), xr.device)
    a_r = xr.reshape(bfold, r)
    a_i = xi.reshape(bfold, r)
    with full_float32():
        yr = torch.matmul(a_r, Fr) - torch.matmul(a_i, Fi)
        yi = torch.matmul(a_r, Fi) + torch.matmul(a_i, Fr)
    K = len(factors)
    perm = (0,) + tuple(range(K, 0, -1))
    yr = yr.reshape(B, *factors).permute(perm).reshape(B, n)
    yi = yi.reshape(B, *factors).permute(perm).reshape(B, n)
    return yr, yi


def fft_split_pipeline(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                       factors=(64, 128, 128), scale: float | None = None):
    """FFT of [B, n] planes from fused stages: K-1 `fused_stage` calls, the
    leaf contraction (`torch.matmul`, float32) and the digit reversal.
    Forward unscaled / inverse 1/n; `scale` multiplies on top, folded
    into the leaf's table."""
    return _pipeline(xr, xi, direction, factors, scale, fused_stage)


def fft_split_pipeline_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                             factors=(64, 128, 128), scale: float | None = None):
    """`fft_split_pipeline` with every stage's plain version, on any
    device."""
    return _pipeline(xr, xi, direction, factors, scale, fused_stage_plain)
