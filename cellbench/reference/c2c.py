"""Plain reference of the batched c2c FFT on split planes: torch.fft in
complex128 on the float32 inputs, forward unscaled, inverse 1/n. The
control is the same transform in TF32 (`tf32.dft_tf32`)."""

from __future__ import annotations

import torch

from cellbench.reference.tf32 import dft_tf32


def make_constants(config: dict, gen: torch.Generator, device) -> dict:
    """A c2c transform takes nothing beyond its input."""
    return {}


def reference(xr, xi, consts: dict, config: dict, direction: str) -> torch.Tensor:
    """complex128 [rows, n]."""
    x = torch.complex(xr.double(), xi.double())
    return torch.fft.fft(x) if direction == "forward" else torch.fft.ifft(x)


def control(xr, xi, consts: dict, config: dict, direction: str):
    """float32 planes [rows, n] of the same transform in TF32."""
    return dft_tf32(xr, xi, inverse=direction != "forward")
