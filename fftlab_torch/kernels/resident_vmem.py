"""FFT for power-of-two n in 2^15..2^20 (counterpart of
fftlab/kernels/resident_vmem.py, the `resident_v6` default).

On the TPU this window runs in ONE residency: the whole signal (8 MB of
split float32 at 2^20) sits in 16 MB of VMEM while both four-step passes
run on it, so device memory is touched once each way. A Hopper block has
at most 227 KB of shared memory, so the signal cannot stay inside one
block, and no block can see another's shared memory across the
transform. This module therefore runs the same four-step math as the
two-pass kernels of `fourstep_vmem` (one kernel pair computes what both
TPU kernels compute); the 50 MB L2 is the nearest the card has to the
TPU's residency.
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, is_power_of_two
from fftlab_torch.kernels.fourstep_vmem import fft_split_large

MIN_N = 1 << 15
MAX_N = 1 << 20


def supported_resident(n: int) -> bool:
    return is_power_of_two(n) and MIN_N <= n <= MAX_N


def fft_split_resident(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                       scale: float | None = None):
    """Batched FFT on split planes [..., n], pow2 n in 2^15..2^20, through
    the two-pass kernels. Forward unscaled / inverse 1/n, natural order;
    `scale` multiplies on top."""
    n = int(xr.shape[-1])
    if not supported_resident(n):
        raise ValueError(
            f"fft_split_resident supports pow2 n in [{MIN_N}, {MAX_N}]; got {n}")
    return fft_split_large(xr, xi, direction, scale)
