"""Sharded overlap-save filtering on split re/im planes (counterpart of
fftlab/dist/overlap_save_split.py:51-159).

The time axis splits into contiguous blocks, one per rank of the
`time_axis`. Each rank prepends its left neighbour's last nh - 1 samples
(the halo; rank 0 gets zeros, the causal start), filters [halo, block]
with a single-device `FilterPlan`'s route, and keeps the outputs from
index nh - 1 on: the `os_filter` kernel (K11) where the taps fit its
frame (`os_filter_vmem.taps_fit`), the tensor-op blocks otherwise; on
CPU tensors the kernel's plain version. The split pair doubles as a
two-for-one channel packer: a real response is Hermitian, so two real
channels packed as (xr, xi) come out filtered independently.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.dist import comm
from fftlab_torch.dist.mesh import axis, block, mesh_device, on_mesh
from fftlab_torch.kernels._common import check_planes


def with_halo(x: torch.Tensor, group, keep: int) -> torch.Tensor:
    """[..., chunk] -> [..., keep + chunk]: the left neighbour's last
    `keep` samples in front (zeros on the first rank of `group`)."""
    if not keep:
        return x
    return torch.cat([comm.shift(x[..., -keep:].contiguous(), group, 1), x], dim=-1)


def check_chunk(n: int, p: int, nh: int, axis_name: str) -> None:
    """n must split into p blocks, each at least the halo nh - 1 long."""
    if n % p:
        raise ValueError(f"n={n} not divisible by {axis_name}={p}")
    if n // p < nh - 1:
        raise ValueError(f"chunk {n // p} shorter than filter halo {nh - 1}")


@functools.lru_cache(maxsize=64)
def _plan(h_bytes: bytes, shape: tuple, fft_size: int | None, device: torch.device):
    from fftlab_torch.plan.filter_plan import FilterPlan

    h = np.frombuffer(h_bytes, dtype=np.float32).reshape(shape)
    return FilterPlan(h, fft_size, device=device)


def causal_plan(h, fft_size: int | None, device: torch.device):
    """The single-device `FilterPlan` of the real taps h on `device`,
    built once per taps, fft_size and device (its response computed and
    moved to the device once); only its stateless `causal` is used."""
    h = np.ascontiguousarray(h, dtype=np.float32)
    return _plan(h.tobytes(), h.shape, fft_size, torch.device(device))


def filter_sharded(plan, xr: torch.Tensor, xi: torch.Tensor, mesh, axis_name: str):
    """This rank's block of `plan.causal` of the whole planes [..., n],
    time split over `mesh[axis_name]` (a plan on this rank's device)."""
    p, _, group = axis(mesh, axis_name)
    check_chunk(int(xr.shape[-1]), p, plan.nh, axis_name)
    keep = plan.nh - 1
    both = with_halo(torch.stack([block(xr, mesh, axis_name, -1),
                                  block(xi, mesh, axis_name, -1)]), group, keep)
    yr, yi = plan.causal(both[0], both[1])
    return yr[..., keep:], yi[..., keep:]


def overlap_save_filter_sharded_split(xr, xi, h, mesh,
                                      axis_name: str = "sp",
                                      fft_size: int | None = None):
    """Causal FIR filtering of a split signal pair, time-sharded with a
    halo exchange.

    xr, xi: the same whole [..., n] float32 planes on every rank (or two
    REAL channels packed as a pair). h: [nh] real taps. Returns this
    rank's block [..., n/p] of convolve(x, h)[..., :n] on each plane.
    """
    xr, xi = on_mesh(xr, mesh), on_mesh(xi, mesh)
    check_planes(xr, xi, "overlap_save_filter_sharded_split")
    h = np.asarray(h.cpu() if isinstance(h, torch.Tensor) else h, dtype=np.float32)
    plan = causal_plan(h, fft_size, mesh_device(mesh))
    return filter_sharded(plan, xr, xi, mesh, axis_name)


def overlap_save_filterbank_sharded_split(x, h_bank, mesh,
                                          channel_axis: str = "dp",
                                          time_axis: str = "sp",
                                          fft_size: int | None = None):
    """Multi-channel filterbank on split planes: real channels split over
    `channel_axis`, time over `time_axis`, each channel with its own taps
    (its plane pair carries (channel, zero)).

    x: the same whole [channels, n] real signal on every rank; h_bank:
    [channels, nh] real taps. Returns this rank's block
    [channels/pc, n/pt].
    """
    x = on_mesh(x, mesh).float()
    h_bank = np.asarray(h_bank.cpu() if isinstance(h_bank, torch.Tensor) else h_bank,
                        dtype=np.float32)
    c, n = int(x.shape[-2]), int(x.shape[-1])
    nh = int(h_bank.shape[-1])
    pc, ic, _ = axis(mesh, channel_axis)
    pt, _, group = axis(mesh, time_axis)
    if c % pc or n % pt:
        raise ValueError(f"shape ({c},{n}) not divisible by mesh ({pc},{pt})")
    if n // pt < nh - 1:
        raise ValueError(f"chunk {n // pt} shorter than halo {nh - 1}")
    xl = with_halo(block(block(x, mesh, channel_axis, 0), mesh, time_axis, -1), group,
                   nh - 1)
    dev = mesh_device(mesh)
    taps = h_bank[ic * (c // pc):(ic + 1) * (c // pc)]
    out = [causal_plan(h, fft_size, dev).causal(row, torch.zeros_like(row))[0]
           for h, row in zip(taps, xl)]
    return torch.stack(out)[..., nh - 1:]
