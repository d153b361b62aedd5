"""Checks and tables shared by the kernel wrappers."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fftlab_torch.core.types import Direction, log2_int
from fftlab_torch.kernels import _build


class DtypeError(TypeError, ValueError):
    """A tensor of a dtype the port does not take. Nothing is cast: the
    split planes have always raised a TypeError here, and the real-signal
    entry points a ValueError (where the JAX package casts to float32
    without a word), so this is both."""


def check_planes(xr: torch.Tensor, xi: torch.Tensor, name: str) -> None:
    """Split planes: float32 tensors of one shape on one device. Nothing is
    cast: a float64 or half input is refused, not converted."""
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise DtypeError(f"{name} takes float32 planes; got {xr.dtype}, {xi.dtype}")
    if xr.shape != xi.shape:
        raise ValueError(f"{name}: re/im shape mismatch {tuple(xr.shape)} vs {tuple(xi.shape)}")
    if xr.device != xi.device:
        raise ValueError(f"{name}: re/im on different devices {xr.device}, {xi.device}")


def check_real(x, name: str) -> None:
    """A real signal: a float32 tensor. Nothing is cast."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        got = x.dtype if isinstance(x, torch.Tensor) else type(x).__name__
        raise DtypeError(f"{name} takes a float32 tensor; got {got}")


def check_aligned(*tensors: torch.Tensor, name: str) -> None:
    """A kernel that reads or writes (x[2j], x[2j+1]) as one float2 needs
    8-byte aligned rows; a view at an odd offset is refused, not copied."""
    for t in tensors:
        if t.data_ptr() % 8:
            raise ValueError(f"{name} reads float2 pairs and needs 8-byte aligned "
                             f"data; got a view at an odd element offset")


def check_cuda(*tensors: torch.Tensor, name: str) -> None:
    """A kernel launch takes contiguous CUDA tensors only."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} launches a CUDA kernel; got a tensor on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def check_response(hr: torch.Tensor, hi: torch.Tensor, n: int,
                   like: torch.Tensor, name: str) -> None:
    """H for a kernel: two float32 planes of n bins on `like`'s device."""
    check_planes(hr, hi, name)
    if tuple(hr.shape) != (n,) or hr.device != like.device:
        raise ValueError(f"{name} takes H as ({n},) planes on {like.device}; "
                         f"got {tuple(hr.shape)} on {hr.device}")


def response_planes(hr, hi, like: torch.Tensor):
    """H (numpy or tensor, any float dtype) as contiguous float32 planes on
    `like`'s device: the form the kernels read. A response is a constant
    of the plan, so it is cast; the signal planes never are."""
    as_t = lambda h: torch.as_tensor(h, dtype=torch.float32,
                                     device=like.device).contiguous()
    return as_t(hr), as_t(hi)


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


def radix_schedule(L: int) -> tuple[int, ...]:
    """The passes of the register engine (csrc/fft_reg.cuh) for pow2 L:
    radix 16 while four bits are left, then one pass of the leftover radix
    8, 4 or 2. Their product is L."""
    e = log2_int(L)
    return (16,) * (e // 4) + ((1 << (e % 4),) if e % 4 else ())


def pass_twiddle_np(L: int, direction) -> np.ndarray:
    """The register engine's twiddle table for length L, in float64: for
    each pass after the first (radix R, sub-transform length ns > 1), the
    values W_{ns*R}^{r*k} for r < R, k < ns as R/2 rows of ns pairs
    (W^{2h*k}, W^{(2h+1)*k}): entry [(h*ns + k)*2 + e] holds r = 2h + e;
    the passes one after another (csrc/fft_reg.cuh `twiddle`). A length
    of at most 16 is one pass and has an empty table."""
    rows = []
    ns = 1
    for R in radix_schedule(L):
        if ns > 1:
            rk = np.arange(ns)[:, None] * np.arange(R)[None, :]
            w = np.exp(2j * np.pi * float(int(direction)) * rk / (ns * R))  # (ns, R)
            rows.append(w.reshape(ns, R // 2, 2).transpose(1, 0, 2).ravel())
        ns *= R
    return np.concatenate(rows) if rows else np.zeros(0, np.complex128)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The launch of a register-engine kernel (csrc/fft_reg.cuh): a tile
    of T transforms of length L per block, 16 values per thread, and the
    exchange's planes (re, then im): element e of transform t at
    t*stride + e + (e >> log_pad) floats, or, with log_pad = 0 (a single
    row, no pad), at e ^ ((e >> 4) & 31), or, with log_pad = FRAME_ROWS
    (stacked rows), at t*stride + (e ^ ((e >> 4) & 31)). The C side
    checks it (`valid_geometry`) and runs what it is given."""
    L: int
    T: int
    schedule: tuple[int, ...]
    threads: int
    smem: int
    log_pad: int
    stride: int

    def c_struct(self) -> _build.Geometry:
        last = self.schedule[-1] if self.schedule[-1] != 16 else 1
        return _build.Geometry(self.threads, self.smem, log2_int(last), self.log_pad,
                               self.stride)


def tile_geometry(L: int, T: int) -> TileGeometry:
    """The geometry of a tile of T transforms of length L: T*L/16 threads,
    and a single row swizzled with no pad (T = 1) or one pad float every
    16 with a row stride of L + L/16 + 4 (T > 1): the layouts that a
    model of the engine's bank accesses chose (tests/test_torch_geometry.py)."""
    log_pad, stride = (0, L) if T == 1 else (4, L + L // 16 + 4)
    return TileGeometry(L, T, radix_schedule(L), T * L // 16, 8 * T * stride, log_pad, stride)


# The layout of stacked swizzled rows, in the place of a log_pad
# (csrc/fft_reg.cuh `kFrameRows`).
FRAME_ROWS = -1


def frame_geometry(L: int, T: int) -> TileGeometry:
    """The geometry of a tile of T transforms of length L whose every pass
    puts neighbouring threads on neighbouring elements of one transform
    (the filter kernels): each transform a row swizzled as a single row,
    the rows L floats apart, T*L/16 threads. A model of the bank accesses
    chose it over the padded tile, whose exchanges take two wavefronts
    under that slot mapping (tests/test_torch_geometry.py)."""
    return TileGeometry(L, T, radix_schedule(L), T * L // 16, 8 * T * L, FRAME_ROWS, L)
