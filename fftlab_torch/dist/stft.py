"""Frame-sharded STFT (counterpart of fftlab/dist/stft.py:34-96): the
streaming analyzer's hop loop distributed over a mesh axis.

The time axis splits into contiguous blocks; each rank owns the frames
that start inside its block. A frame overlaps the next fft_size - hop
samples, so a rank's last frames reach into the next block: the right
neighbour sends that head (`comm.shift` down the chain; the last rank
gets zeros, the tail's zero extension). The frames run on the tensor-op
Stockham, as the JAX function runs them.
"""

from __future__ import annotations

import torch

from fftlab_torch.algos.stockham import stockham_fft_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import complex_dtype_for
from fftlab_torch.core.window import get_window
from fftlab_torch.dist import comm
from fftlab_torch.dist.mesh import axis, block, on_mesh


def stft_sharded(x, mesh, axis_name: str = "sp",
                 fft_size: int = 2048, hop: int = 512, window="hann",
                 onesided: bool | None = None):
    """Sharded STFT: the same whole [..., n] on every rank -> this rank's
    block [..., n/(p*hop), bins] of the [..., n//hop, bins] spectrogram,
    frames split over `mesh[axis_name]`.

    Framing: frames start at k*hop for k in [0, n//hop); the signal is
    zero-extended at the tail (the analyzer's steady-state streaming
    view). Requires hop | chunk and chunk >= fft_size - hop.
    """
    x = on_mesh(x, mesh)
    n = int(x.shape[-1])
    p, _, group = axis(mesh, axis_name)
    if n % p:
        raise ValueError(f"n={n} not divisible by {axis_name}={p}")
    chunk = n // p
    if chunk % hop:
        raise ValueError(f"chunk {chunk} not divisible by hop {hop}")
    if fft_size - hop > chunk:
        raise ValueError(
            f"frame overlap {fft_size - hop} exceeds chunk {chunk}"
        )
    if onesided is None:
        onesided = not x.is_complex()
    bins = fft_size // 2 + 1 if onesided else fft_size
    w = torch.as_tensor(get_window(window, fft_size), device=x.device,
                        dtype=torch.float64 if x.dtype == torch.float64 else torch.float32)
    xl = block(x, mesh, axis_name, -1)
    halo = fft_size - hop
    if halo > 0:
        xl = torch.cat([xl, comm.shift(xl[..., :halo].contiguous(), group, -1)], dim=-1)
    frames = frame_signal_strided(xl, fft_size, hop, chunk // hop) * w
    X = stockham_fft_unscaled(frames.to(complex_dtype_for(frames.dtype)))
    return X[..., :bins]
