"""Route selection for the split-plane FFT and the FFT -> H -> IFFT
sandwich (counterpart of fftlab/plan/dispatch.py:49-102 and :146-313).

Routes (split re/im float32 planes, [..., n] batch-first):

  smem_rows       n = m*128, 8K <= n <= 16K: one block per row
                  (kernels/fft_vmem.py; the JAX `pallas_vmem` window)
  two_pass        pow2 n in 2^15..2^21: the two-pass four-step kernels
                  (kernels/fourstep_vmem.py; the JAX `resident_v6` and
                  `fourstep_vmem` windows)
  three_pass      pow2 n in 2^22..2^26: the three-pass kernel
                  (kernels/threestep_vmem.py; the JAX `threestep_vmem`
                  window, where 2^21 also stays on two passes)
  stage_pipeline  pow2 n >= 256, only when asked for (FFTLAB_FORCE_IMPL,
                  or `plan_from_jax` of a JAX `pallas_pipeline` plan):
                  fused radix stages (kernels/stage_fused.py) with
                  `pipeline_factors(n)`
  einsum          every other size: tensor-op Stockham, at the leaf
                  recorded for n (`split_tuning.best_leaf`)

Sandwich routes (`spectral_filter_auto`, ifft(fft(x) * H), 1/n scaled):

  smem_rows  n = m*128, 1K <= n <= 16K: one block per row runs the
             whole sandwich (kernel `filter_rows`, kernels/fft_vmem.py)
  two_pass   pow2 n in 2^15..2^21: three launches, pass 1, pass 2's
             sandwich mode (the row FFT, H, the row IFFT and the inverse
             twiddle in one kernel) and the inverse pass 1
             (kernels/fourstep_vmem.py `spectral_filter_large`); 2^21
             included, where the JAX package stops at 2^20 for a TPU
             compiler crash
  einsum     every other size: the transpose-free tensor-op sandwich
             (algos/split_stockham.spectral_filter_split_fused)

The route depends on n only, never on the device: a kernel route on a
CPU tensor runs that kernel's plain version, and on a CUDA tensor
launches the kernel or raises. FFTLAB_FORCE_IMPL=<route> pins the FFT
route; for the sandwich, FFTLAB_FORCE_IMPL=einsum pins the tensor-op
route and any other value leaves the route to n.
"""

from __future__ import annotations

import math
import os

import torch

from fftlab_torch.core.types import FORWARD
from fftlab_torch.utils import trace

ROUTES = ("smem_rows", "two_pass", "three_pass", "stage_pipeline", "einsum")

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
    from fftlab_torch.kernels.threestep_vmem import supported_huge

    if supported_size(n) and n >= _ROWS_MIN_N:
        return "smem_rows"
    if supported_large(n):
        return "two_pass"
    if supported_huge(n):
        return "three_pass"
    return "einsum"


def _pipeline_entry(xr: torch.Tensor, xi: torch.Tensor, direction, *, scale=None):
    from fftlab_torch.kernels.stage_fused import fft_split_pipeline, pipeline_factors

    n = int(xr.shape[-1])
    B = math.prod(xr.shape[:-1])
    yr, yi = fft_split_pipeline(xr.reshape(B, n), xi.reshape(B, n), direction,
                                pipeline_factors(n), scale=scale)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


def _einsum_entry(xr: torch.Tensor, xi: torch.Tensor, direction, *, scale=None):
    from fftlab_torch.algos.split_stockham import fft_split
    from fftlab_torch.plan.split_tuning import best_leaf

    # the leaf `tune_split_leaf` measured for n here, else the default
    yr, yi = fft_split(xr, xi, direction, best_leaf(int(xr.shape[-1]), xr.device))
    if scale is None:
        return yr, yi
    return yr * scale, yi * scale


def _route_entry(route: str):
    """The entry of a named route: fn(xr, xi, direction, *, scale)."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; want one of {ROUTES}")
    if route == "smem_rows":
        from fftlab_torch.kernels.fft_vmem import fft_split_rows

        return fft_split_rows
    if route == "two_pass":
        from fftlab_torch.kernels.fourstep_vmem import fft_split_large

        return fft_split_large
    if route == "three_pass":
        from fftlab_torch.kernels.threestep_vmem import fft_split_huge

        return fft_split_huge
    if route == "stage_pipeline":
        return _pipeline_entry
    return _einsum_entry


def run_route(route: str, xr: torch.Tensor, xi: torch.Tensor, direction,
              scale: float | None = None):
    """Execute a split-plane FFT through a named route. `scale` multiplies
    the output; the kernel routes fold it into their last stage, the
    einsum route multiplies after. While the recorder is on, the body is
    the span `dispatch` and the route's entry the span `wrapper` under it
    (utils/trace.py)."""
    if not trace.on():
        return _route_entry(route)(xr, xi, direction, scale=scale)
    dispatch = trace.begin("dispatch")
    try:
        entry = _route_entry(route)
        wrapper = trace.begin("wrapper")
        try:
            return entry(xr, xi, direction, scale=scale)
        finally:
            trace.end(wrapper)
    finally:
        trace.end(dispatch)


def _split_auto(xr: torch.Tensor, xi: torch.Tensor, direction):
    if direction is None:
        direction = FORWARD
    n = int(xr.shape[-1])
    return run_route(select_split_impl(n, math.prod(xr.shape[:-1])),
                     xr, xi, direction)


def fft_split_auto(xr: torch.Tensor, xi: torch.Tensor, direction=None):
    """Split-plane FFT through the route `select_split_impl` picks; the
    recorder's root span `execute` while it is on."""
    if not trace.on():
        return _split_auto(xr, xi, direction)
    rec = trace.begin("execute")
    try:
        return _split_auto(xr, xi, direction)
    finally:
        trace.end(rec)


def select_filter_impl(n: int) -> str:
    """Route for an n-point FFT -> H -> IFFT sandwich."""
    if os.environ.get("FFTLAB_FORCE_IMPL") == "einsum":
        return "einsum"
    from fftlab_torch.kernels.fft_vmem import supported_size
    from fftlab_torch.kernels.fourstep_vmem import supported_large

    if supported_size(n):
        return "smem_rows"
    if supported_large(n):
        return "two_pass"
    return "einsum"


def _filter_entry(n: int, permuted):
    """The sandwich entry of the route `select_filter_impl` picks for n:
    fn(xr, xi, hr, hi)."""
    route = select_filter_impl(n)
    if route == "smem_rows":
        from fftlab_torch.kernels.fft_vmem import pallas_spectral_filter

        return pallas_spectral_filter
    if route == "two_pass":
        from fftlab_torch.kernels.fourstep_vmem import spectral_filter_large

        return spectral_filter_large
    from fftlab_torch.algos.split_stockham import spectral_filter_split_fused

    if permuted is None:
        return spectral_filter_split_fused
    return lambda xr, xi, hr, hi: spectral_filter_split_fused(xr, xi, *permuted,
                                                              h_permuted=True)


def spectral_filter_auto(xr: torch.Tensor, xi: torch.Tensor, hr, hi,
                         permuted=None):
    """ifft(fft(x) * H), 1/n scaled, on split planes [..., n] through the
    route `select_filter_impl` picks: the one dispatcher that dsp.filtering,
    dsp.convolution and Bluestein's convolution share.

    hr, hi: the n-bin response in natural bin order, numpy or a tensor.
    `permuted` optionally gives a digit-reversed copy (hr_p, hi_p) for the
    einsum route (`split_stockham.permute_response`), so a cached
    plan-time constant is not permuted again on every call. While the
    recorder is on: the root span `execute`, `dispatch` under it, and the
    route's entry as `wrapper` (utils/trace.py)."""
    if not trace.on():
        return _filter_entry(int(xr.shape[-1]), permuted)(xr, xi, hr, hi)
    root = trace.begin("execute")
    dispatch = trace.begin("dispatch")
    try:
        entry = _filter_entry(int(xr.shape[-1]), permuted)
        wrapper = trace.begin("wrapper")
        try:
            return entry(xr, xi, hr, hi)
        finally:
            trace.end(wrapper)
    finally:
        trace.end(dispatch)
        trace.end(root)
