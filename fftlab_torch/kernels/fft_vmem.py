"""Batched row FFT for n = m*128 (m in 8..128, pow2): the `smem_rows`
route (counterpart of fftlab/kernels/fft_vmem.py:42-75 and :158-215), and
the FFT -> H -> IFFT sandwich of such rows (:237-282).

On a CUDA tensor the hand-written kernel `fft_rows` (csrc/fft_rows.cu)
runs: one block per row on the register engine of csrc/fft_reg.cuh
(radix-16 passes in registers, the row in shared memory only between
passes), natural order out, at the launch geometry of `rows_geometry`.
On a CPU tensor the plain version runs: the JAX kernel's math
(`_fwd_body`) in tensor ops with the same tables,

    view x as B[j2, j1] (m, 128), j = j1 + 128*j2
    C  = F_m @ B           # column FFTs over j2
    C *= W_n^{j1*k2}       # inter-stage twiddle
    D  = C @ F_128^T       # row FFTs over j1
    out = D^T              # (128, m); flattens to natural order

Forward unscaled, inverse 1/n; `scale` multiplies the output on top and
is folded into the last stage (the kernel) or the last table (plain).
`pallas_fft_split_ad` is `fft_split_rows` with its adjoint for autograd
(kernels/_ad.py; fftlab/kernels/fft_vmem.py:297).

The sandwich `pallas_spectral_filter` launches `filter_rows`
(csrc/filter.cu) on a CUDA tensor: one row per block on the same engine
and geometry as `fft_rows`, the forward FFT's spectrum left in the
exchange planes, the inverse's first pass reading it times H in natural
bin order, its last pass storing with 1/n: one read and one write of the
row. Its plain version is the plain row FFT, the multiply and the plain
inverse.
"""

from __future__ import annotations


import numpy as np
import torch

from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import (FORWARD, Direction, as_complex_array,
                                     is_power_of_two, log2_int)
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._ad import make_differentiable
from fftlab_torch.kernels._common import (
    TileGeometry,
    check_cuda,
    check_planes,
    check_response,
    complex_table,
    effective_scale,
    on_cpu,
    pass_twiddle_np,
    response_planes,
    rows_of,
    tile_geometry,
)
from fftlab_torch.utils import trace

N1 = 128

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"fft_rows": 0, "filter_rows": 0}


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


@trace.table_cache(maxsize=32)
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
    with full_float32():
        cr = torch.matmul(Fmr, x3r) - torch.matmul(Fmi, x3i)
        ci = torch.matmul(Fmr, x3i) + torch.matmul(Fmi, x3r)
        tr = cr * twr - ci * twi
        ti = cr * twi + ci * twr
        dr = torch.matmul(tr, F1r.T) - torch.matmul(ti, F1i.T)
        di = torch.matmul(tr, F1i.T) + torch.matmul(ti, F1r.T)
    return (dr.transpose(1, 2).reshape(B, n),
            di.transpose(1, 2).reshape(B, n))


@trace.table_cache(maxsize=32)
def _engine_twiddle(n: int, direction: Direction, device: torch.device):
    """The register engine's per-pass table for length n (fft_reg.cuh)."""
    return complex_table(pass_twiddle_np(n, direction), device)


@trace.table_cache(maxsize=16)
def rows_geometry(n: int) -> TileGeometry:
    """The launch of `fft_rows` and `filter_rows` at pow2 n in
    [512, 16384]: one row per block on n/16 threads (one row per SM at
    16384, two or more below)."""
    return tile_geometry(n, 1)


def fft_rows(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
             scale: float = 1.0):
    """Launch the CUDA kernel on contiguous [B, n] float32 planes (pow2 n,
    512 <= n <= 16384); `scale` is the whole output scale."""
    mark = trace.phases()
    direction = Direction(int(direction))
    check_planes(xr, xi, "fft_rows")
    check_cuda(xr, xi, name="fft_rows")
    B, n = xr.shape
    if not (is_power_of_two(n) and 512 <= n <= 16384):
        raise ValueError(f"fft_rows takes pow2 n in [512, 16384]; got {n}")
    mark()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    mark()
    tw = _engine_twiddle(n, direction, xr.device)
    _build.launch("fftlab_fft_rows", "fft_rows", LAUNCHES, xr,
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), B,
                   log2_int(n), rows_geometry(n).c_struct(), int(direction), float(scale)),
                  mark)
    return yr, yi


def fft_split_rows(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD, *,
                   scale: float | None = None):
    """Batched FFT on split planes [..., n], n = m*128 with m in 8..128
    pow2: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. Forward unscaled / inverse 1/n; `scale` multiplies on top.
    `scale` is keyword-only: the JAX function's 4th parameter is
    `interpret`, so a JAX-order call raises here instead of scaling."""
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


# K3's split entry under the JAX package's name (fftlab/kernels/fft_vmem.py:197)
pallas_fft_split = fft_split_rows

pallas_fft_split_ad = make_differentiable(fft_split_rows)


def pallas_fft(x, direction=FORWARD):
    """The complex entry to `fft_split_rows` (fftlab/kernels/fft_vmem.py:223):
    a complex tensor [..., n] as float32 planes through the row kernel (one
    `fft_rows` launch on a CUDA tensor, the plain version on a CPU one),
    complex64 out, as the JAX function computes in float32 whatever it is
    given. Non-tensors are placed as `core.types.as_tensor` places them."""
    x = as_complex_array(x)
    yr, yi = fft_split_rows(x.real.float().contiguous(), x.imag.float().contiguous(),
                            direction)
    return torch.complex(yr, yi)


def spectral_filter_rows_plain(xr: torch.Tensor, xi: torch.Tensor,
                               hr: torch.Tensor, hi: torch.Tensor):
    """Plain version of `filter_rows` on [B, n] planes: ifft(fft(x) * H),
    1/n scaled, with H in natural bin order."""
    n = int(xr.shape[-1])
    fr, fi = fft_rows_plain(xr, xi, Direction.FORWARD, 1.0)
    gr, gi = fr * hr - fi * hi, fr * hi + fi * hr
    return fft_rows_plain(gr, gi, Direction.INVERSE, 1.0 / n)


def filter_rows(xr: torch.Tensor, xi: torch.Tensor, hr: torch.Tensor,
                hi: torch.Tensor):
    """Launch the row sandwich on contiguous [B, n] CUDA float32 planes
    (pow2 n, 512 <= n <= 16384); hr, hi: the n-bin response, natural
    order. Returns ifft(fft(x) * H), 1/n scaled."""
    mark = trace.phases()
    check_planes(xr, xi, "filter_rows")
    check_cuda(xr, xi, hr, hi, name="filter_rows")
    B, n = xr.shape
    if not (is_power_of_two(n) and 512 <= n <= 16384):
        raise ValueError(f"filter_rows takes pow2 n in [512, 16384]; got {n}")
    check_response(hr, hi, n, xr, "filter_rows")
    mark()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    mark()
    tw_fwd = _engine_twiddle(n, Direction.FORWARD, xr.device)
    tw_inv = _engine_twiddle(n, Direction.INVERSE, xr.device)
    _build.launch("fftlab_filter_rows", "filter_rows", LAUNCHES, xr,
                  (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                   tw_fwd.data_ptr(), tw_inv.data_ptr(), hr.data_ptr(), hi.data_ptr(), B,
                   log2_int(n), rows_geometry(n).c_struct(), 1.0 / n), mark)
    return yr, yi


def pallas_spectral_filter(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """The FFT -> H -> IFFT sandwich of every row of [..., n] split planes,
    n = m*128 with m in 8..128 pow2: `filter_rows` for a CUDA tensor, the
    plain version for a CPU tensor. hr, hi: the n-bin response in natural
    order. Equal to ifft(fft(x) * H), 1/n scaled."""
    check_planes(xr, xi, "pallas_spectral_filter")
    n = int(xr.shape[-1])
    if not supported_size(n):
        raise ValueError(f"pallas_spectral_filter supports n = m*128, m in "
                         f"8..128 pow2; got {n}")
    hr, hi = response_planes(hr, hi, xr)
    B = rows_of(xr.shape)
    run = (spectral_filter_rows_plain if on_cpu(xr, "pallas_spectral_filter")
           else filter_rows)
    yr, yi = run(xr.reshape(B, n), xi.reshape(B, n), hr, hi)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)
