"""A DFT in TF32: the control that a correct run must tell apart.

A four-step DFT of length n = N1 * N2 whose matrix products take TF32
operands (float32 rounded to a 10-bit mantissa, round to nearest even,
as a tensor core reads them) and accumulate in float32; the twiddles are
applied in float32. This is how a tensor-core DFT would compute the
transform, the step a later change might be tempted to take. The
rounding is done here, so the control reads the same on the CPU and on
the card; TF32 matmuls are switched off while it runs.
"""

from __future__ import annotations

import contextlib
import math

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


@contextlib.contextmanager
def _tf32_off():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _dft_matrix(m: int, sign: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.arange(m, dtype=torch.float64, device=device)
    ang = sign * 2.0 * math.pi * torch.outer(k, k) / m
    return to_tf32(torch.cos(ang).float()), to_tf32(torch.sin(ang).float())


def _cmm(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi), TF32 operands, float32 sums."""
    ar, ai, br, bi = (to_tf32(t) for t in (ar, ai, br, bi))
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def dft_tf32(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False):
    """DFT over the last axis of float32 planes [B, n] (n a power of two),
    in TF32; the inverse is 1/n scaled. Returns float32 planes [B, n]."""
    B, n = xr.shape
    e = int(math.log2(n))
    n1 = 1 << (e // 2)
    n2 = n // n1
    sign = 1 if inverse else -1
    dev = xr.device
    with _tf32_off():
        # input index j = n2*j1 + j2, as (B, j1, j2)
        f1r, f1i = _dft_matrix(n1, sign, dev)
        ar, ai = _cmm(f1r, f1i, xr.reshape(B, n1, n2), xi.reshape(B, n1, n2))  # (B, k1, j2)
        k1 = torch.arange(n1, dtype=torch.float64, device=dev)
        j2 = torch.arange(n2, dtype=torch.float64, device=dev)
        ang = sign * 2.0 * math.pi * torch.outer(k1, j2) / n
        wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
        ar, ai = ar * wr - ai * wi, ar * wi + ai * wr
        f2r, f2i = _dft_matrix(n2, sign, dev)
        cr, ci = _cmm(ar, ai, f2r, f2i)  # (B, k1, k2); output index k = k1 + n1*k2
    yr = cr.transpose(1, 2).reshape(B, n)
    yi = ci.transpose(1, 2).reshape(B, n)
    if inverse:
        yr, yi = yr / n, yi / n
    return yr, yi
