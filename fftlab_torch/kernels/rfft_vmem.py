"""The real-signal prologue and epilogue of the pack-two-reals r2c/c2r
(counterpart of fftlab/kernels/rfft_vmem.py).

A real [..., n] signal (n = 2m) is read as the complex sequence
z[j] = x[2j] + i*x[2j+1] of m points; its half-size spectrum Z gives the
one-sided spectrum as

    E_k = (Z[k] + conj(Z[m-k])) / 2,   O_k = -i (Z[k] - conj(Z[m-k])) / 2,
    X[k] = E_k + W_n^k O_k   (k = 0..m),  X[m] = Re Z[0] - Im Z[0].

On a CUDA tensor the hand-written kernels of csrc/real.cu run:
`pack_real` (one float2 load of (x[2j], x[2j+1]) per point),
`interleave` (its inverse, one float2 store), `herm_unpack` (one thread
per pair (k, m-k), the paired form of split_stockham.py:214-242, the
Nyquist bin written by the kernel) and `herm_repack` (the inverse of
the unpack, the paired form of split_stockham.py:299-325; the first
phase of the JAX fused c2r kernel, rfft_resident.py:348-390). The JAX
kernels are 0/1 permutation matmuls because lane gathers were slow on
the TPU (rfft_vmem.py:4-22); a strided load does the same job here.

On a CPU tensor the plain versions run: strided views for the pack, a
stack for the interleave, the unpaired full-range unpack of
rfft_vmem.py:217-223 with the Nyquist bin appended as
rfft_vmem.py:283-286 appends it, and the paired repack in tensor ops.
The paired and unpaired unpacks agree to float32 rounding.
"""

from __future__ import annotations


import numpy as np
import torch

from fftlab_torch.core.types import Direction
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (
    check_aligned,
    check_cuda,
    check_planes,
    check_real,
    complex_table,
    on_cpu,
    rows_of,
)
from fftlab_torch.utils import trace

LANES = 128

# Launches of the CUDA kernels since the counts were last reset.
LAUNCHES = {"pack_real": 0, "interleave": 0, "herm_unpack": 0, "herm_repack": 0}


def pack_supported(n: int) -> bool:
    """The JAX kernels' window: n even with n/2 a multiple of 1024."""
    m = n // 2
    return n % 2 == 0 and m % (LANES * 8) == 0


@trace.table_cache(maxsize=32)
def _pair_twiddle(n: int, direction: Direction, device: torch.device):
    """exp(2*pi*i*direction*k/n), built in float64 for k = 0..n/4 (one per
    pair), as a float32 (n/4 + 1, 2) re/im table on `device`: the table of
    the paired unpack (FORWARD) and repack (INVERSE), kernel and plain."""
    k = np.arange(n // 4 + 1, dtype=np.float64)
    return complex_table(np.exp(2j * np.pi * float(int(direction)) * k / n), device)


@trace.table_cache(maxsize=32)
def _unpack_twiddle_plain(n: int, device: torch.device):
    """W_n^k for k = 0..n/2-1 as float32 planes (rfft_vmem.py:235-238)."""
    w = np.exp(-2j * np.pi * np.arange(n // 2, dtype=np.float64) / n)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return as_t(w.real), as_t(w.imag)


# ---------------------------------------------------------- plain versions


def pack_real_plain(x: torch.Tensor):
    """Plain version of `pack_real`: the even and odd samples as strided
    views, [..., n] -> two [..., n/2]."""
    return x[..., 0::2], x[..., 1::2]


def interleave_plain(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Plain version of `interleave`: [..., m] planes -> real [..., 2m]."""
    return torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], 2 * zr.shape[-1])


def herm_unpack_plain(zr: torch.Tensor, zi: torch.Tensor, n: int,
                      scale: float = 1.0):
    """Plain version of `herm_unpack`: half-size spectrum Z [..., m] ->
    one-sided X [..., m+1], the unpaired full-range form of
    rfft_vmem.py:217-223 (bins 0..m-1), the Nyquist bin
    Re Z[0] - Im Z[0] appended; the output times `scale`."""
    h = 0.5 * float(scale)
    # Zh[k] = Z[(m-k) % m] = [Z[0], Z[m-1], ..., Z[1]]
    zhr = torch.roll(torch.flip(zr, [-1]), 1, -1)
    zhi = torch.roll(torch.flip(zi, [-1]), 1, -1)
    er, ei = h * (zr + zhr), h * (zi - zhi)
    o_r, o_i = h * (zi + zhi), -h * (zr - zhr)
    wr, wi = _unpack_twiddle_plain(n, zr.device)
    xr = er + (o_r * wr - o_i * wi)
    xi = ei + (o_r * wi + o_i * wr)
    nyq = 2.0 * h * (zr[..., :1] - zi[..., :1])
    return (torch.cat([xr, nyq], dim=-1),
            torch.cat([xi, torch.zeros_like(nyq)], dim=-1))


def herm_repack_plain(xr: torch.Tensor, xi: torch.Tensor):
    """Plain version of `herm_repack`: one-sided X [..., m+1] (m even) ->
    the half-size sequence Z [..., m] whose inverse c2c (with 1/m) is the
    even/odd planes of the real signal. The paired tensor-op form of
    split_stockham.py:299-325."""
    m = int(xr.shape[-1]) - 1
    half = m // 2
    xlr, xli = xr[..., : half + 1], xi[..., : half + 1]
    xhr = torch.flip(xr[..., half:], [-1])  # Xh[k] = X[m-k]
    xhi = torch.flip(xi[..., half:], [-1])
    er, ei = 0.5 * (xlr + xhr), 0.5 * (xli - xhi)
    dr, di = 0.5 * (xlr - xhr), 0.5 * (xli + xhi)
    w = _pair_twiddle(2 * m, Direction.INVERSE, xr.device)
    wr, wi = w[:, 0], w[:, 1]
    o_r, o_i = dr * wr - di * wi, dr * wi + di * wr
    low_r, low_i = er - o_i, ei + o_r  # Z bins 0..m/2
    high_r, high_i = er + o_i, o_r - ei  # conj(E - i*O): Z[m-k]
    return (torch.cat([low_r, torch.flip(high_r[..., 1:half], [-1])], dim=-1),
            torch.cat([low_i, torch.flip(high_i[..., 1:half], [-1])], dim=-1))


# ---------------------------------------------------------- kernel launches


def _check_launch(name: str, *tensors: torch.Tensor) -> None:
    check_cuda(*tensors, name=name)
    for t in tensors:
        if t.dim() != 2:
            raise ValueError(f"{name} takes [B, n] tensors; got {tuple(t.shape)}")


def pack_real(x: torch.Tensor):
    """Launch `pack_real` on a contiguous [B, n] CUDA float32 signal (n
    even, 8-byte aligned); returns the even and odd planes [B, n/2]."""
    mark = trace.phases()
    check_real(x, "pack_real")
    _check_launch("pack_real", x)
    check_aligned(x, name="pack_real")
    B, n = x.shape
    if n % 2:
        raise ValueError(f"pack_real takes an even length; got {n}")
    mark()
    zr = torch.empty(B, n // 2, device=x.device)
    zi = torch.empty_like(zr)
    mark()  # no table: the argument tuple alone
    _build.launch("fftlab_pack_real", "pack_real", LAUNCHES, x,
                  (x.data_ptr(), zr.data_ptr(), zi.data_ptr(), zr.numel()), mark)
    return zr, zi


def interleave(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Launch `interleave` on contiguous [B, m] CUDA float32 planes;
    returns the real [B, 2m] signal."""
    mark = trace.phases()
    check_planes(zr, zi, "interleave")
    _check_launch("interleave", zr, zi)
    B, m = zr.shape
    mark()
    x = torch.empty(B, 2 * m, device=zr.device)
    mark()  # no table: the argument tuple alone
    _build.launch("fftlab_interleave", "interleave", LAUNCHES, zr,
                  (zr.data_ptr(), zi.data_ptr(), x.data_ptr(), zr.numel()), mark)
    return x


def herm_unpack(zr: torch.Tensor, zi: torch.Tensor, scale: float = 1.0):
    """Launch `herm_unpack` on contiguous [B, m] CUDA float32 half-size
    spectra (m even); returns the one-sided [B, m+1] planes, bins 0..m,
    times `scale`."""
    mark = trace.phases()
    check_planes(zr, zi, "herm_unpack")
    _check_launch("herm_unpack", zr, zi)
    B, m = zr.shape
    if m < 2 or m % 2:
        raise ValueError(f"herm_unpack takes an even half size m >= 2; got {m}")
    mark()
    xr = torch.empty(B, m + 1, device=zr.device)
    xi = torch.empty_like(xr)
    mark()
    tw = _pair_twiddle(2 * m, Direction.FORWARD, zr.device)
    _build.launch("fftlab_herm_unpack", "herm_unpack", LAUNCHES, zr,
                  (zr.data_ptr(), zi.data_ptr(), xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), B,
                   m, float(scale)), mark)
    return xr, xi


def herm_repack(xr: torch.Tensor, xi: torch.Tensor):
    """Launch `herm_repack` on contiguous [B, m+1] CUDA float32 one-sided
    spectra (m even); returns the half-size [B, m] planes for the inverse
    c2c."""
    mark = trace.phases()
    check_planes(xr, xi, "herm_repack")
    _check_launch("herm_repack", xr, xi)
    B, h = xr.shape
    m = h - 1
    if m < 2 or m % 2:
        raise ValueError(f"herm_repack takes m+1 bins with m even, m >= 2; got {h}")
    mark()
    zr = torch.empty(B, m, device=xr.device)
    zi = torch.empty_like(zr)
    mark()
    tw = _pair_twiddle(2 * m, Direction.INVERSE, xr.device)
    _build.launch("fftlab_herm_repack", "herm_repack", LAUNCHES, xr,
                  (xr.data_ptr(), xi.data_ptr(), zr.data_ptr(), zi.data_ptr(), tw.data_ptr(), B,
                   m), mark)
    return zr, zi


# ------------------------------------------------- entry points (any device)


def pallas_pack_real(x: torch.Tensor):
    """x real [..., n] -> (even, odd) planes [..., n//2]: `pack_real` on a
    CUDA tensor, the strided views on a CPU tensor."""
    check_real(x, "pallas_pack_real")
    n = int(x.shape[-1])
    if not pack_supported(n):
        raise ValueError(f"pack needs n/2 % {LANES * 8} == 0; got n={n}")
    if on_cpu(x, "pallas_pack_real"):
        return pack_real_plain(x)
    B = rows_of(x.shape)
    zr, zi = pack_real(x.reshape(B, n))
    return zr.reshape(*x.shape[:-1], n // 2), zi.reshape(*x.shape[:-1], n // 2)


def pallas_interleave(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """(even, odd) planes [..., m] -> real [..., 2m] (the pack's inverse)."""
    check_planes(zr, zi, "pallas_interleave")
    m = int(zr.shape[-1])
    if not pack_supported(2 * m):
        raise ValueError(f"interleave needs m % {LANES * 8} == 0; got {m}")
    if on_cpu(zr, "pallas_interleave"):
        return interleave_plain(zr, zi)
    B = rows_of(zr.shape)
    x = interleave(zr.reshape(B, m), zi.reshape(B, m))
    return x.reshape(*zr.shape[:-1], 2 * m)


def pallas_hermitian_unpack(zr: torch.Tensor, zi: torch.Tensor, n: int):
    """Half-size spectrum Z [..., m] -> one-sided X bins 0..m (m = n/2),
    Nyquist bin Re Z[0] - Im Z[0] included."""
    check_planes(zr, zi, "pallas_hermitian_unpack")
    m = int(zr.shape[-1])
    if n != 2 * m:
        raise ValueError(f"n must be 2*m; got n={n}, m={m}")
    if not pack_supported(n):
        raise ValueError(f"unpack needs m % {LANES * 8} == 0; got {m}")
    if on_cpu(zr, "pallas_hermitian_unpack"):
        return herm_unpack_plain(zr, zi, n)
    B = rows_of(zr.shape)
    xr, xi = herm_unpack(zr.reshape(B, m), zi.reshape(B, m))
    return xr.reshape(*zr.shape[:-1], m + 1), xi.reshape(*zr.shape[:-1], m + 1)


def hermitian_repack(xr: torch.Tensor, xi: torch.Tensor, n: int):
    """One-sided X [..., n/2+1] -> the half-size sequence Z [..., n/2]
    whose inverse c2c gives the even/odd planes of the real signal (n/2
    even): `herm_repack` on a CUDA tensor, its plain version on a CPU
    tensor. The JAX package runs this step in XLA."""
    check_planes(xr, xi, "hermitian_repack")
    m = n // 2
    if n % 4 or m < 2 or int(xr.shape[-1]) != m + 1:
        raise ValueError(f"hermitian_repack takes n/2+1 bins with n % 4 == 0; "
                         f"got {xr.shape[-1]} bins for n={n}")
    if on_cpu(xr, "hermitian_repack"):
        return herm_repack_plain(xr, xi)
    B = rows_of(xr.shape)
    zr, zi = herm_repack(xr.reshape(B, m + 1), xi.reshape(B, m + 1))
    return zr.reshape(*xr.shape[:-1], m), zi.reshape(*xr.shape[:-1], m)
