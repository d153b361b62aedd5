"""Batched row FFT for n = m*128 (m in 8..128, pow2): the `smem_rows`
route (counterpart of fftlab/kernels/fft_vmem.py:42-75 and :158-215).

On a CUDA tensor the hand-written kernel `fft_rows` (csrc/fft_rows.cu)
runs: one block per row, the whole row in shared memory, a radix-4
Stockham FFT, natural order out. On a CPU tensor the plain version runs:
the JAX kernel's math (`_fwd_body`) in tensor ops with the same tables,

    view x as B[j2, j1] (m, 128), j = j1 + 128*j2
    C  = F_m @ B           # column FFTs over j2
    C *= W_n^{j1*k2}       # inter-stage twiddle
    D  = C @ F_128^T       # row FFTs over j1
    out = D^T              # (128, m); flattens to natural order

Forward unscaled, inverse 1/n; `scale` multiplies the output on top and
is folded into the last stage (the kernel) or the last table (plain).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
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

N1 = 128

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"fft_rows": 0}


def supported_size(n: int) -> bool:
    """n = m*128 with 8 <= m <= 128 and m a power of two."""
    if n % N1:
        return False
    m = n // N1
    return 8 <= m <= 128 and is_power_of_two(m)


def _tables(n: int, direction: Direction, scale: float | None = None):
    """Host tables of the plain version as float32 numpy: F_m, F_128 and
    W_n^{j1*k2}, each as (re, im). `scale` folds an output normalization
    into F_128, the last contraction. Equal to the JAX kernel's tables."""
    m = n // N1
    Fm = dft_matrix_np(m, direction)
    F1 = dft_matrix_np(N1, direction)
    if scale is not None:
        F1 = F1 * float(scale)
    tw = stage_twiddle_np(m, N1, direction)  # tw[k2, j1] = W_n^{j1*k2}
    c = lambda a: np.ascontiguousarray(a).astype(np.float32)
    return (c(Fm.real), c(Fm.imag), c(F1.real), c(F1.imag),
            c(tw.real), c(tw.imag))


@functools.lru_cache(maxsize=32)
def _plain_tables(n: int, direction: Direction, scale: float,
                  device: torch.device):
    tabs = _tables(n, direction, None if scale == 1.0 else scale)
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


def fft_rows_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                   scale: float = 1.0):
    """Plain tensor-op version of `fft_rows` on [B, n] planes; `scale` is
    the whole output scale (the inverse's 1/n included)."""
    B, n = xr.shape
    m = n // N1
    Fmr, Fmi, F1r, F1i, twr, twi = _plain_tables(
        n, Direction(int(direction)), float(scale), xr.device)
    x3r = xr.reshape(B, m, N1)
    x3i = xi.reshape(B, m, N1)
    cr = torch.matmul(Fmr, x3r) - torch.matmul(Fmi, x3i)
    ci = torch.matmul(Fmr, x3i) + torch.matmul(Fmi, x3r)
    tr = cr * twr - ci * twi
    ti = cr * twi + ci * twr
    dr = torch.matmul(tr, F1r.T) - torch.matmul(ti, F1i.T)
    di = torch.matmul(tr, F1i.T) + torch.matmul(ti, F1r.T)
    return (dr.transpose(1, 2).reshape(B, n),
            di.transpose(1, 2).reshape(B, n))


@functools.lru_cache(maxsize=32)
def _device_twiddle(n: int, direction: Direction, device: torch.device):
    return complex_table(twiddle_np(n, direction), device)


def fft_rows(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
             scale: float = 1.0):
    """Launch the CUDA kernel on contiguous [B, n] float32 planes (pow2 n,
    512 <= n <= 16384); `scale` is the whole output scale."""
    direction = Direction(int(direction))
    check_planes(xr, xi, "fft_rows")
    check_cuda(xr, xi, name="fft_rows")
    B, n = xr.shape
    if not (is_power_of_two(n) and 512 <= n <= 16384):
        raise ValueError(f"fft_rows takes pow2 n in [512, 16384]; got {n}")
    lib = _build.load_library()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tw = _device_twiddle(n, direction, xr.device)
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_fft_rows(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw.data_ptr(), B, log2_int(n), int(direction), float(scale),
            stream_of(xr))
    _build.check(lib, "fft_rows", rc)
    LAUNCHES["fft_rows"] += 1
    return yr, yi


def fft_split_rows(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                   scale: float | None = None):
    """Batched FFT on split planes [..., n], n = m*128 with m in 8..128
    pow2: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. Forward unscaled / inverse 1/n; `scale` multiplies on top."""
    check_planes(xr, xi, "fft_split_rows")
    n = int(xr.shape[-1])
    if not supported_size(n):
        raise ValueError(
            f"fft_split_rows supports n = m*128, m in 8..128 pow2; got {n}")
    eff = effective_scale(n, direction, scale)
    B = rows_of(xr.shape)
    run = fft_rows_plain if on_cpu(xr, "fft_split_rows") else fft_rows
    yr, yi = run(xr.reshape(B, n), xi.reshape(B, n), direction, eff)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)
