"""FFT and FFT -> H -> IFFT sandwich for power-of-two n in 2^15..2^20
(counterpart of fftlab/kernels/resident_vmem.py: the `resident_v6`
default and the sandwich variants v2, cio, v5 and v7).

On the TPU this window runs in ONE residency: the whole signal (8 MB of
split float32 at 2^20) sits in 16 MB of VMEM while both four-step passes
run on it, so device memory is touched once each way. A Hopper block has
at most 227 KB of shared memory, so the signal cannot stay inside one
block, and no block can see another's shared memory across the
transform. This module therefore runs the same four-step math as the
two-pass kernels of `fourstep_vmem` (one kernel pair computes what both
TPU kernels compute); the 50 MB L2 is the nearest the card has to the
TPU's residency.

The FFT variants (v6 and cio) and the sandwich variants differ on the
TPU only in where their corner turns and DMA edges sit inside the one
residency; here each FFT variant is the same two launches of
`fourstep_vmem.fft_split_large`, and each sandwich the same three
launches of `fourstep_vmem.spectral_filter_large`: the resident
kernel's three phases (`_resident_filter_kernel`: the column FFT and
forward twiddle, `_mid`, the inverse column FFT), each a launch, `_mid`
as pass 2's sandwich mode (`fourstep_pass2_sandwich`: the row FFT, H,
the row IFFT and the inverse twiddle, written back over its rows).
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, is_power_of_two
from fftlab_torch.kernels.fourstep_vmem import fft_split_large, spectral_filter_large

MIN_N = 1 << 15
MAX_N = 1 << 20


def supported_resident(n: int) -> bool:
    return is_power_of_two(n) and MIN_N <= n <= MAX_N


def fft_split_resident(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD, *,
                       scale: float | None = None):
    """Batched FFT on split planes [..., n], pow2 n in 2^15..2^20, through
    the two-pass kernels. Forward unscaled / inverse 1/n, natural order;
    `scale` multiplies on top."""
    n = int(xr.shape[-1])
    if not supported_resident(n):
        raise ValueError(
            f"fft_split_resident supports pow2 n in [{MIN_N}, {MAX_N}]; got {n}")
    return fft_split_large(xr, xi, direction, scale=scale)


# The cio variant (fftlab/kernels/resident_vmem.py:689) differs on the TPU
# only in how its copies in and out of VMEM are laid out (its `in_rows`
# and `out_rows`); here it is the same two launches.
fft_split_resident_cio = fft_split_resident


def _filter(name: str, xr, xi, hr, hi):
    n = int(xr.shape[-1])
    if not supported_resident(n):
        raise ValueError(f"{name} supports pow2 n in [{MIN_N}, {MAX_N}]; got {n}")
    return spectral_filter_large(xr, xi, hr, hi)


def spectral_filter_resident(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """ifft(fft(x) * H), 1/n scaled, on split planes [..., n], pow2 n in
    2^15..2^20; hr, hi: the n-bin response in natural order."""
    return _filter("spectral_filter_resident", xr, xi, hr, hi)


def spectral_filter_resident_cio(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """The cio variant's contract: as `spectral_filter_resident`."""
    return _filter("spectral_filter_resident_cio", xr, xi, hr, hi)


def spectral_filter_resident_v5(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """The v5 variant's contract: as `spectral_filter_resident`."""
    return _filter("spectral_filter_resident_v5", xr, xi, hr, hi)


def spectral_filter_resident_v7(xr: torch.Tensor, xi: torch.Tensor, hr, hi):
    """The v7 variant's contract: as `spectral_filter_resident`."""
    return _filter("spectral_filter_resident_v7", xr, xi, hr, hi)
