"""Plain reference of the batched r2c FFT: torch.fft.rfft in complex128
of the real float32 plane, its n/2+1 one-sided bins, forward unscaled,
in natural order with DC and Nyquist. The imaginary plane the harness
draws is not read.

The reference is an FFT in complex128 with no matrix product, so TF32
cannot reach it whatever the backend flags say. The control is where
TF32 enters, on purpose: the first n/2+1 bins of the c2c transform in
TF32 (`tf32.dft_tf32`) of the real plane beside a zero imaginary plane,
the step below float32 that a correct run must tell apart."""

from __future__ import annotations

import torch

from cellbench.reference.tf32 import dft_tf32


def make_constants(config: dict, gen: torch.Generator, device) -> dict:
    """An r2c transform takes nothing beyond its input."""
    return {}


def _forward_only(direction: str) -> None:
    if direction != "forward":
        raise ValueError(f"an r2c runs forward; got direction {direction!r}")


def reference(xr, xi, consts: dict, config: dict, direction: str) -> torch.Tensor:
    """complex128 [rows, n/2+1]."""
    _forward_only(direction)
    return torch.fft.rfft(xr.double())


def control(xr, xi, consts: dict, config: dict, direction: str):
    """float32 planes [rows, n/2+1] of the same transform in TF32."""
    _forward_only(direction)
    yr, yi = dft_tf32(xr, torch.zeros_like(xr))
    h = xr.shape[-1] // 2 + 1
    return yr[..., :h], yi[..., :h]
