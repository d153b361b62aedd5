"""Welch PSD with segments split over a mesh axis and one sum across the
ranks (counterpart of fftlab/dist/welch.py:34-93).

The overlapping segments are independent, so each rank takes its run of
ceil(n_seg/p) of them (the last rank may pad with empty ones, masked),
and the average becomes one `psum` (`comm.psum`). The segments run on
the tensor-op Stockham, as the JAX function runs them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.algos.stockham import stockham_fft_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import complex_dtype_for
from fftlab_torch.core.window import get_window, power_gain
from fftlab_torch.dist import comm
from fftlab_torch.dist.mesh import axis, on_mesh


def welch_psd_sharded(x, mesh, axis_name: str = "dp",
                      sample_rate: float = 1.0, window_size: int = 256,
                      overlap: float = 0.5, window="hann"):
    """Sharded Welch PSD of a real 1D signal, the same whole signal on
    every rank. Returns (freqs, psd), the whole PSD on every rank,
    matching `fftlab_torch.dsp.spectrum.welch_psd`."""
    x = on_mesh(x, mesh)
    if x.ndim != 1:
        raise ValueError(
            f"welch_psd_sharded expects a 1D signal, got shape {tuple(x.shape)} "
            f"(batch the unsharded dsp.spectrum.welch_psd)"
        )
    n = int(x.shape[-1])
    hop = max(int(window_size * (1.0 - overlap)), 1)
    n_seg = max((n - window_size) // hop + 1, 1)
    w_np = get_window(window, window_size)
    p, idx, group = axis(mesh, axis_name)
    per = -(-n_seg // p)  # segments per rank
    h = window_size // 2 + 1
    base = idx * per
    span = (per - 1) * hop + window_size
    # every rank's segments in bounds: pad the signal to the last one's end
    need = (p * per - 1) * hop + window_size
    xp = F.pad(x, (0, max(need - n, 0)))
    w = torch.as_tensor(w_np, dtype=x.dtype, device=x.device)
    segs = frame_signal_strided(xp[base * hop:base * hop + span], window_size, hop, per) * w
    X = stockham_fft_unscaled(segs.to(complex_dtype_for(segs.dtype)))
    psd = (X.real ** 2 + X.imag ** 2)[:, :h]
    valid = (torch.arange(per, device=x.device) + base) < n_seg
    total = comm.psum(torch.where(valid[:, None], psd, 0.0).sum(dim=0), group)
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if window_size % 2 == 0:
        dbl[-1] = 1.0
    scale = 1.0 / (sample_rate * window_size * power_gain(w_np))
    psd = total / n_seg * scale * torch.as_tensor(dbl, dtype=total.dtype, device=x.device)
    freqs = np.arange(window_size // 2 + 1) * sample_rate / window_size
    return freqs, psd
