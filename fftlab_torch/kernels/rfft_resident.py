"""Fused r2c / c2r for n/2 a power of two in 2^15..2^20 (counterpart of
fftlab/kernels/rfft_resident.py).

On the TPU each direction is ONE residency: the 8 MB real signal sits
in VMEM while the pack, the half-size c2c and the Hermitian unpack run
on it. A Hopper block has 227 KB of shared memory, so, as for the c2c
(kernels/resident_vmem.py), the transform runs on the two-pass kernels
and the pack and interleave are fused into their load and store:

  rfft_resident   fourstep_pass1_packed -> fourstep_pass2 -> herm_unpack
                  (three launches; the pipeline of rfft_split takes four:
                  pack_real -> pass 1 -> pass 2 -> herm_unpack)
  irfft_resident  herm_repack -> fourstep_pass1 -> fourstep_pass2_interleaved
                  with 1/m in pass 2's scale

`scale` multiplies the output: the unpack's 0.5 factors carry it in the
r2c, pass 2's last stage in the c2r. As in the JAX package, the c2r
applies 1/m = 2/n and nothing else: the composition
irfft_resident(rfft_resident(x)) is x. On a CPU tensor the plain
versions of the same launches run.
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import INVERSE
from fftlab_torch.kernels._common import check_planes, check_real, on_cpu, rows_of
from fftlab_torch.kernels.fourstep_vmem import (
    fourstep_pass1,
    fourstep_pass1_packed,
    fourstep_pass1_packed_plain,
    fourstep_pass1_plain,
    fourstep_pass2,
    fourstep_pass2_interleaved,
    fourstep_pass2_interleaved_plain,
    fourstep_pass2_plain,
)
from fftlab_torch.kernels.resident_vmem import supported_resident
from fftlab_torch.kernels.rfft_vmem import (
    herm_repack,
    herm_repack_plain,
    herm_unpack,
    herm_unpack_plain,
)


def supported_rfft_resident(n: int) -> bool:
    """Even n whose half is in the resident c2c window (2^15..2^20)."""
    return n % 2 == 0 and supported_resident(n // 2)


def rfft_resident_plain(x: torch.Tensor, scale: float = 1.0):
    """Plain version of the fused r2c on a real [B, n] signal: pass 1 of
    the strided even/odd views, pass 2, the unpaired unpack."""
    n = int(x.shape[-1])
    zr, zi = fourstep_pass2_plain(*fourstep_pass1_packed_plain(x))
    return herm_unpack_plain(zr, zi, n, scale)


def _rfft_launches(x: torch.Tensor, scale: float = 1.0):
    return herm_unpack(*fourstep_pass2(*fourstep_pass1_packed(x)), scale)


def irfft_resident_plain(xr: torch.Tensor, xi: torch.Tensor, scale: float = 1.0):
    """Plain version of the fused c2r on [B, m+1] planes: the paired
    repack, then the plain inverse passes with 1/m (times `scale`),
    interleaved into the real [B, 2m] signal."""
    m = int(xr.shape[-1]) - 1
    mid = fourstep_pass1_plain(*herm_repack_plain(xr, xi), INVERSE)
    return fourstep_pass2_interleaved_plain(*mid, INVERSE, scale / m)


def _irfft_launches(xr: torch.Tensor, xi: torch.Tensor, scale: float = 1.0):
    m = int(xr.shape[-1]) - 1
    mid = fourstep_pass1(*herm_repack(xr, xi), INVERSE)
    return fourstep_pass2_interleaved(*mid, INVERSE, scale / m)


def rfft_resident(x: torch.Tensor, scale: float | None = None):
    """Real [..., n] float32 -> one-sided (re, im) [..., n//2+1]: three
    launches on a CUDA tensor, their plain versions on a CPU tensor.
    `scale` multiplies the spectrum. Requires supported_rfft_resident(n);
    another dtype is refused, not cast."""
    check_real(x, "rfft_resident")
    n = int(x.shape[-1])
    if not supported_rfft_resident(n):
        raise ValueError(
            f"rfft_resident supports even n with n//2 in the resident "
            f"window [2^15, 2^20]; got n={n}")
    B = rows_of(x.shape)
    run = rfft_resident_plain if on_cpu(x, "rfft_resident") else _rfft_launches
    yr, yi = run(x.reshape(B, n), 1.0 if scale is None else float(scale))
    h = n // 2 + 1
    return yr.reshape(*x.shape[:-1], h), yi.reshape(*x.shape[:-1], h)


def irfft_resident(Xr: torch.Tensor, Xi: torch.Tensor, scale: float | None = None):
    """One-sided (re, im) [..., n//2+1] float32 -> real [..., n]: three
    launches on a CUDA tensor, their plain versions on a CPU tensor. 1/m
    (m = n/2) is applied inside, and nothing else, so
    irfft_resident(rfft_resident(x)) == x; `scale` multiplies on top."""
    check_planes(Xr, Xi, "irfft_resident")
    h = int(Xr.shape[-1])
    n = 2 * (h - 1)
    if not supported_rfft_resident(n):
        raise ValueError(
            f"irfft_resident supports h = n//2+1 with n//2 in the resident "
            f"window [2^15, 2^20]; got h={h}")
    B = rows_of(Xr.shape)
    run = irfft_resident_plain if on_cpu(Xr, "irfft_resident") else _irfft_launches
    y = run(Xr.reshape(B, h), Xi.reshape(B, h), 1.0 if scale is None else float(scale))
    return y.reshape(*Xr.shape[:-1], n)
