"""Checks and tables shared by the kernel wrappers."""

from __future__ import annotations

import math

import numpy as np
import torch

from fftlab_torch.core.types import Direction


def check_planes(xr: torch.Tensor, xi: torch.Tensor, name: str) -> None:
    """Split planes: float32 tensors of one shape on one device. Nothing is
    cast: a float64 or half input is refused, not converted."""
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 planes; got {xr.dtype}, {xi.dtype}")
    if xr.shape != xi.shape:
        raise ValueError(f"{name}: re/im shape mismatch {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.device != xi.device:
        raise ValueError(f"{name}: re/im on different devices {xr.device}, {xi.device}")


def check_cuda(*tensors: torch.Tensor, name: str) -> None:
    """A kernel launch takes contiguous CUDA tensors only."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} launches a CUDA kernel; got a tensor on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def on_cpu(xr: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises."""
    if xr.device.type == "cpu":
        return True
    if xr.device.type == "cuda":
        return False
    raise ValueError(f"{name} runs on CPU or CUDA tensors; got {xr.device}")


def effective_scale(n: int, direction, scale: float | None) -> float:
    """The output scale a transform folds into its last stage: 1/n for the
    inverse, times the caller's `scale`."""
    eff = 1.0 / n if Direction(int(direction)) == Direction.INVERSE else 1.0
    return eff * (1.0 if scale is None else float(scale))


def rows_of(shape: torch.Size) -> int:
    """Number of length-n rows in a [..., n] tensor."""
    return math.prod(shape[:-1])


def complex_table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Complex numpy table -> float32 (..., 2) interleaved re/im on `device`."""
    pair = np.stack([a.real, a.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(pair)).to(device)


def twiddle_np(L: int, direction) -> np.ndarray:
    """tw[m] = exp(2*pi*i*direction*m/L), m < L, in float64: the table the
    shared-memory Stockham stages read (csrc/fft_smem.cuh)."""
    m = np.arange(L, dtype=np.float64)
    return np.exp(2j * np.pi * float(int(direction)) * m / L)


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream
