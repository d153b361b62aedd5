"""Pipeline-parallel (PP) streaming spectral pipeline (counterpart of
fftlab/dist/pp_pipeline.py:46-170): the serving sandwich window -> FFT
-> xH -> IFFT as pipeline stages on the ranks of a mesh axis, time
blocks flowing down the chain as microbatches.

With P ranks and B blocks the loop runs B + P - 1 ticks. At each tick
rank d applies its stage group (4/P contiguous stages) to the block
rank d - 1 handed over (rank 0 takes block t of the input), then every
block in flight moves one hop down the chain in one `comm.shift`.
Finished blocks collect on rank P - 1, which broadcasts them at the end
(where the JAX package sums masked copies). The FFTs run on the kernels
(`four_step_split.local_fft`: `fft_rows` at 1024..16384 points).
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.core.types import FORWARD, INVERSE
from fftlab_torch.dist import comm
from fftlab_torch.dist.four_step_split import local_fft
from fftlab_torch.dist.mesh import axis, on_mesh
from fftlab_torch.kernels._common import check_planes

N_STAGES = 4  # window | forward FFT | xH | inverse FFT (1/n)


def pp_spectral_pipeline_split(blocks_r, blocks_i, hr, hi, mesh,
                               axis_name: str = "pp", window=None):
    """Filter B time blocks through the 4-stage pipeline over
    `mesh[axis_name]` (P must be 1, 2 or 4: each rank runs a contiguous
    run of window/FFT/xH/IFFT).

    blocks_r, blocks_i: the same whole [B, n] planes on every rank (the
    caller frames the stream; each block is filtered circularly).
    hr, hi: length-n frequency response, natural bin order. window:
    length-n taps (default all ones). Returns the whole [B, n] pair on
    every rank: per block ifft(fft(window * b) * H), 1/n scaled.
    """
    blocks_r, blocks_i = on_mesh(blocks_r, mesh), on_mesh(blocks_i, mesh)
    if blocks_r.ndim != 2:
        raise ValueError(
            f"expected [B, n] blocks, got shape {tuple(blocks_r.shape)}"
        )
    check_planes(blocks_r, blocks_i, "pp_spectral_pipeline_split")
    B, n = int(blocks_r.shape[0]), int(blocks_r.shape[1])
    p, d, group = axis(mesh, axis_name)
    if N_STAGES % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide {N_STAGES} pipeline "
            f"stages (use 1, 2, or 4 devices on this axis)"
        )
    if window is None:
        window = np.ones(n, np.float32)
    plane = lambda v: on_mesh(v, mesh).to(torch.float32)
    w = plane(window)
    if int(w.shape[-1]) != n:
        raise ValueError(f"window length {w.shape[-1]} != block size {n}")
    hr_, hi_ = plane(hr), plane(hi)
    if int(hr_.shape[-1]) != n:
        raise ValueError(f"response length {hr_.shape[-1]} != block size {n}")

    stages = [
        lambda ar, ai: (ar * w, ai * w),
        lambda ar, ai: local_fft(ar, ai, FORWARD),
        lambda ar, ai: (ar * hr_ - ai * hi_, ar * hi_ + ai * hr_),
        lambda ar, ai: local_fft(ar, ai, INVERSE),
    ]
    group_size = N_STAGES // p
    mine = stages[d * group_size:(d + 1) * group_size]
    buf = torch.zeros(2, n, device=blocks_r.device)
    out = torch.zeros(2, B, n, device=blocks_r.device)
    for t in range(B + p - 1):
        if d > 0:
            ar, ai = buf[0], buf[1]
        elif t < B:  # rank 0 ingests block t
            ar, ai = blocks_r[t], blocks_i[t]
        else:  # past the end: zeros, which only drain the chain
            ar, ai = torch.zeros_like(buf)
        for stage in mine:
            ar, ai = stage(ar, ai)
        done = t - (p - 1)
        if d == p - 1 and done >= 0:  # the last rank finishes block t - (P-1)
            out[0, done], out[1, done] = ar, ai
        if p > 1:
            buf = comm.shift(torch.stack([ar, ai]), group, 1)
    out = comm.broadcast(out, group, p - 1)
    return out[0], out[1]
