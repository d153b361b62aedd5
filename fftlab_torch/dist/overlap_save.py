"""Sharded streaming FIR filtering on complex tensors: overlap-save with
time blocks split over a mesh axis and a halo exchange (counterpart of
fftlab/dist/overlap_save.py:50-190).

Each rank needs the nh - 1 samples before its block (the halo), which
its left neighbour sends (`comm.shift`; rank 0 gets zeros: causal
linear filtering). Then it runs an ordinary batched overlap-save on
[halo, block]: all frames as one strided view, one batch of FFT -> H ->
IFFT on the tensor-op Stockham (complex taps are allowed, which the
split-plane kernel path does not take).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fftlab_torch.algos.stockham import stockham_fft_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import INVERSE, complex_dtype_for, next_power_of_two
from fftlab_torch.dist.mesh import axis, block, on_mesh
from fftlab_torch.dist.overlap_save_split import with_halo


def _local_overlap_save(xp: torch.Tensor, H: torch.Tensor, chunk: int, nh: int,
                        fft_size: int) -> torch.Tensor:
    """Valid-output overlap-save on a halo-prefixed block: xp
    [..., nh - 1 + chunk] -> [..., chunk],
    y[t] = sum_tau h[tau] * x[block_start + t - tau]."""
    hop = fft_size - (nh - 1)
    n_blocks = -(-chunk // hop)
    frames = frame_signal_strided(xp, fft_size, hop, n_blocks)
    y = stockham_fft_unscaled(stockham_fft_unscaled(frames) * H, INVERSE) * (1.0 / fft_size)
    y = y[..., nh - 1:]  # the aliased head of each frame
    return y.reshape(*y.shape[:-2], n_blocks * hop)[..., :chunk]


def _fft_size(fft_size: int | None, nh: int) -> int:
    if fft_size is None:
        fft_size = max(next_power_of_two(4 * nh), 256)
    if fft_size < next_power_of_two(2 * nh):
        raise ValueError(f"fft_size {fft_size} too small for {nh} taps")
    return fft_size


def _response(h: torch.Tensor, fft_size: int, cdtype) -> torch.Tensor:
    """FFT of the zero-padded taps [..., nh], in the complex dtype (complex
    taps keep their imaginary part)."""
    h = h.to(cdtype)
    return stockham_fft_unscaled(F.pad(h, (0, fft_size - int(h.shape[-1]))))


def overlap_save_filter_sharded(x, h, mesh, axis_name: str = "sp",
                                fft_size: int | None = None):
    """Causal FIR filter y[t] = sum_tau h[tau]*x[t-tau], t in [0, n), with
    the time axis split over `mesh[axis_name]`.

    x: the same whole [..., n] on every rank, n divisible by the axis
    size; h: [nh] taps, real or complex. Returns this rank's block
    [..., n/p] of fft_convolution(x, h)[..., :n] (real when x and h are).
    """
    x, h = on_mesh(x, mesh), on_mesh(h, mesh)
    was_real = not x.is_complex() and not h.is_complex()
    n, nh = int(x.shape[-1]), int(h.shape[-1])
    p, _, group = axis(mesh, axis_name)
    if n % p:
        raise ValueError(f"signal length {n} not divisible by axis {axis_name}={p}")
    if n // p < nh - 1:
        raise ValueError(
            f"chunk {n // p} shorter than filter halo {nh - 1}; use fewer shards"
        )
    fft_size = _fft_size(fft_size, nh)
    cdtype = complex_dtype_for(torch.result_type(x, h))
    xp = with_halo(block(x.to(cdtype), mesh, axis_name, -1), group, nh - 1)
    y = _local_overlap_save(xp, _response(h, fft_size, cdtype), n // p, nh, fft_size)
    return y.real if was_real else y


def overlap_save_filterbank_sharded(x, h_bank, mesh, channel_axis: str = "dp",
                                    time_axis: str = "sp",
                                    fft_size: int | None = None):
    """Multi-channel filterbank: channels split over `channel_axis` (DP),
    time over `time_axis` (SP).

    x: the same whole [channels, n] on every rank; h_bank: [channels, nh]
    per-channel taps. Returns this rank's block [channels/pc, n/pt].
    """
    x, h_bank = on_mesh(x, mesh), on_mesh(h_bank, mesh)
    was_real = not x.is_complex() and not h_bank.is_complex()
    c, n = int(x.shape[-2]), int(x.shape[-1])
    nh = int(h_bank.shape[-1])
    pc, _, _ = axis(mesh, channel_axis)
    pt, _, group = axis(mesh, time_axis)
    if c % pc or n % pt:
        raise ValueError(f"shape ({c},{n}) not divisible by mesh ({pc},{pt})")
    if n // pt < nh - 1:
        raise ValueError(
            f"time chunk {n // pt} shorter than filter halo {nh - 1}; "
            f"use fewer time shards"
        )
    fft_size = _fft_size(fft_size, nh)
    cdtype = complex_dtype_for(torch.result_type(x, h_bank))
    H = _response(block(h_bank, mesh, channel_axis, 0), fft_size, cdtype)[:, None, :]
    xl = block(block(x.to(cdtype), mesh, channel_axis, 0), mesh, time_axis, -1)
    y = _local_overlap_save(with_halo(xl, group, nh - 1), H, n // pt, nh, fft_size)
    return y.real if was_real else y
