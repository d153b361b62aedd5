"""Route selection for the split-plane FFT (counterpart of
fftlab/plan/dispatch.py:49-102 and :205-313).

Routes (split re/im float32 planes, [..., n] batch-first):

  smem_rows  n = m*128, 8K <= n <= 16K: one block per row
             (kernels/fft_vmem.py; the JAX `pallas_vmem` window)
  two_pass   pow2 n in 2^15..2^21: the two-pass four-step kernels
             (kernels/fourstep_vmem.py; the JAX `resident_v6` and
             `fourstep_vmem` windows)
  einsum     every other size, 2^22 and above included until the
             three-pass kernel (ROADMAP K4) is ported: tensor-op Stockham

The route depends on n only, never on the device: a kernel route on a
CPU tensor runs that kernel's plain version, and on a CUDA tensor
launches the kernel or raises. FFTLAB_FORCE_IMPL=<route> pins the route.
"""

from __future__ import annotations

import math
import os

import torch

from fftlab_torch.core.types import FORWARD

ROUTES = ("smem_rows", "two_pass", "einsum")

# The JAX package's crossover (fftlab/plan/dispatch.py:57): below 8K the
# row kernel does not take the route.
_ROWS_MIN_N = 8192


def select_split_impl(n: int, batch: int = 1) -> str:
    """Route for an n-point split-plane FFT with `batch` rows."""
    forced = os.environ.get("FFTLAB_FORCE_IMPL")
    if forced:
        if forced not in ROUTES:
            raise ValueError(f"FFTLAB_FORCE_IMPL={forced!r}; want one of {ROUTES}")
        return forced
    from fftlab_torch.kernels.fft_vmem import supported_size
    from fftlab_torch.kernels.fourstep_vmem import supported_large

    if supported_size(n) and n >= _ROWS_MIN_N:
        return "smem_rows"
    if supported_large(n):
        return "two_pass"
    return "einsum"


def run_route(route: str, xr: torch.Tensor, xi: torch.Tensor, direction,
              scale: float | None = None):
    """Execute a split-plane FFT through a named route. `scale` multiplies
    the output; the kernel routes fold it into their last stage, the
    einsum route multiplies after."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; want one of {ROUTES}")
    if route == "smem_rows":
        from fftlab_torch.kernels.fft_vmem import fft_split_rows

        return fft_split_rows(xr, xi, direction, scale=scale)
    if route == "two_pass":
        from fftlab_torch.kernels.fourstep_vmem import fft_split_large

        return fft_split_large(xr, xi, direction, scale=scale)
    from fftlab_torch.algos.split_stockham import fft_split

    yr, yi = fft_split(xr, xi, direction)
    if scale is None:
        return yr, yi
    return yr * scale, yi * scale


def fft_split_auto(xr: torch.Tensor, xi: torch.Tensor, direction=None):
    """Split-plane FFT through the route `select_split_impl` picks."""
    if direction is None:
        direction = FORWARD
    n = int(xr.shape[-1])
    return run_route(select_split_impl(n, math.prod(xr.shape[:-1])),
                     xr, xi, direction)
