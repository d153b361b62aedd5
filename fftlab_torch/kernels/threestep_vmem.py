"""Three-pass FFT for huge power-of-two n in 2^21..2^26: the `three_pass`
route (counterpart of fftlab/kernels/threestep_vmem.py).

n = F1*F2*F3 (`_split_three`), j = j1*F2F3 + j2*F3 + j3 and
k = k1 + F1*k2 + F1F2*k3:

  pass A  view (B, F1, F2*F3): column FFT over j1, then W_n^{k1*j23} in
          rank-1 form                                 -> [b, k1, j2, j3]
  pass B  view (B*F1, F2, F3): column FFT over j2, then W_{F2F3}^{k2*j3};
          the (k1, k2) axes swap on the store          -> [b, k2, k1, j3]
  pass C  rows (b, k2, k1) of length F3: FFT over j3, stored at
          k3*F1F2 + k2*F1 + k1, which is the natural order.

On a CUDA tensor three launches run (csrc/fourstep.cu): pass A is
`fourstep_pass1`'s kernel at (L1, L2) = (F1, F2F3), pass B the same
kernel's swap-store mode at (F2, F3) over B*F1 rows, pass C
`fourstep_pass2`'s kernel at (F1F2, F3). The JAX package reuses its
pass-1 kernel the same way (`_pass_col_kernel = _pass1_kernel`). On a CPU
tensor the plain versions of the passes run: the two-pass plain math at
those sides, with the same float64-built tables. Forward unscaled,
inverse 1/n; `scale` multiplies on top, folded into pass C's last stage.

The JAX kernel's layout knobs have no counterpart here: `blocked`
(FFTLAB_TS_BLOCKED: DMA-block-shaped intermediates, bit-equal to the
row-major form in interpret mode), `lanes` (FFTLAB_TS_LANES: pass 3 as an
MXU contraction over the lane axis), `w1` and `r3` (FFTLAB_TS_W1/R3: the
burst widths of pass 1's strided read and pass 3's strided write) shape
Mosaic's DMAs and VMEM slabs. Here every pass reads and writes runs of
16 floats in natural-order intermediates, so they would choose nothing
(ROADMAP, "Not to port": FFTLAB_TS_*).
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, is_power_of_two, log2_int
from fftlab_torch.kernels._ad import make_differentiable
from fftlab_torch.kernels._common import (check_cuda, check_planes, effective_scale,
                                          on_cpu, rows_of)
from fftlab_torch.kernels.fourstep_vmem import (_launch_pass1, _launch_pass2,
                                                pass1_plain, pass2_plain)

MIN_N3 = 1 << 21
MAX_N3 = 1 << 26

# Launches of the CUDA kernels since the counts were last reset.
LAUNCHES = {"threestep_pass_a": 0, "threestep_pass_b": 0, "threestep_pass_c": 0}


def supported_huge(n: int) -> bool:
    return is_power_of_two(n) and MIN_N3 <= n <= MAX_N3


def _split_three(n: int) -> tuple[int, int, int]:
    """n = F1*F2*F3, pow2 sides <= 2048, F3 >= 128, F1*F2 >= 128."""
    e = log2_int(n)
    e3 = max((e + 2) // 3, 7)
    e1 = (e - e3) // 2
    e2 = e - e3 - e1
    return 1 << e1, 1 << e2, 1 << e3


def _sides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    n = int(x.shape[-1])
    if x.dim() != 2 or not supported_huge(n):
        raise ValueError(f"{name} takes [B, n] planes, pow2 n in "
                         f"[{MIN_N3}, {MAX_N3}]; got {tuple(x.shape)}")
    return _split_three(n)


def _swap_k1_k2(t: torch.Tensor, F1: int, F2: int, F3: int) -> torch.Tensor:
    """[b, k1, k2, j3] -> [b, k2, k1, j3], flattened to [B, n]."""
    n = F1 * F2 * F3
    return t.reshape(-1, F1, F2, F3).transpose(1, 2).reshape(-1, n)


# ------------------------------------------------------------ plain versions


def threestep_pass_a_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Plain version of pass A on [B, n] planes -> [b, k1, j2, j3]."""
    F1, F2, F3 = _sides(xr, "threestep_pass_a_plain")
    return pass1_plain(xr, xi, direction, F1, F2 * F3)


def threestep_pass_b_plain(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD):
    """Plain version of pass B: [b, k1, j2, j3] -> [b, k2, k1, j3]."""
    F1, F2, F3 = _sides(mr, "threestep_pass_b_plain")
    B, n = mr.shape
    yr, yi = pass1_plain(mr.reshape(B * F1, F2 * F3), mi.reshape(B * F1, F2 * F3),
                         direction, F2, F3)
    return _swap_k1_k2(yr, F1, F2, F3), _swap_k1_k2(yi, F1, F2, F3)


def threestep_pass_c_plain(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                           scale: float = 1.0):
    """Plain version of pass C: [b, k2, k1, j3] -> the natural-order
    spectrum; `scale` is the whole output scale."""
    F1, F2, F3 = _sides(mr, "threestep_pass_c_plain")
    return pass2_plain(mr, mi, direction, scale, F1 * F2, F3)


def fft_split_huge_plain(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                         scale: float = 1.0):
    """Plain version of the three passes on [B, n] planes; `scale` is the
    whole output scale (the inverse's 1/n included)."""
    mid = threestep_pass_b_plain(*threestep_pass_a_plain(xr, xi, direction), direction)
    return threestep_pass_c_plain(*mid, direction, scale)


# ------------------------------------------------------------- the kernels


def threestep_pass_a(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
    """Launch pass A on contiguous [B, n] CUDA planes."""
    F1, F2, F3 = _sides(xr, "threestep_pass_a")
    return _launch_pass1("threestep_pass_a", xr, xi, direction, (F1, F2 * F3),
                         LAUNCHES)


def threestep_pass_b(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD):
    """Launch pass B on pass A's contiguous [B, n] CUDA output."""
    F1, F2, F3 = _sides(mr, "threestep_pass_b")
    check_planes(mr, mi, "threestep_pass_b")
    check_cuda(mr, mi, name="threestep_pass_b")  # before the row view
    B, n = mr.shape
    yr, yi = _launch_pass1("threestep_pass_b", mr.view(B * F1, F2 * F3),
                           mi.view(B * F1, F2 * F3), direction, (F2, F3),
                           LAUNCHES, swap=F1)
    return yr.view(B, n), yi.view(B, n)


def threestep_pass_c(mr: torch.Tensor, mi: torch.Tensor, direction=FORWARD,
                     scale: float = 1.0):
    """Launch pass C on pass B's contiguous [B, n] CUDA output; returns
    the natural-order spectrum. `scale` is the whole output scale."""
    F1, F2, F3 = _sides(mr, "threestep_pass_c")
    return _launch_pass2("threestep_pass_c", mr, mi, direction, scale,
                         (F1 * F2, F3), LAUNCHES)


def _launches(xr, xi, direction, scale: float):
    mid = threestep_pass_b(*threestep_pass_a(xr, xi, direction), direction)
    return threestep_pass_c(*mid, direction, scale)


def fft_split_huge(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD, *,
                   scale: float | None = None):
    """Batched FFT on split planes [..., n], pow2 n in 2^21..2^26: the
    three CUDA launches for a CUDA tensor, the plain version for a CPU
    tensor. Forward unscaled / inverse 1/n, natural order; `scale`
    multiplies on top, folded into pass C."""
    check_planes(xr, xi, "fft_split_huge")
    n = int(xr.shape[-1])
    if not supported_huge(n):
        raise ValueError(
            f"fft_split_huge supports pow2 n in [{MIN_N3}, {MAX_N3}]; got {n}")
    eff = effective_scale(n, direction, scale)
    B = rows_of(xr.shape)
    run = fft_split_huge_plain if on_cpu(xr, "fft_split_huge") else _launches
    yr, yi = run(xr.reshape(B, n), xi.reshape(B, n), direction, eff)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


fft_split_huge_ad = make_differentiable(fft_split_huge)
