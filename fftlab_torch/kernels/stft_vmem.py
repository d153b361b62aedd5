"""Streaming STFT of a real 1D signal without a frame tensor (counterpart
of fftlab/kernels/stft_vmem.py).

Frame f of fft_size = 2m points starts at f*hop. On a CUDA tensor the
hand-written kernel `stft_frames` (csrc/real.cu) runs: each block loads
T frames straight from the signal as float2 pairs, windows them, runs
the m-point FFT of each packed frame z[j] = x[2j] + i*x[2j+1] on one
shared-memory tile and the Hermitian unpack from the same tile, and
writes bins 0..m (one-sided) or all 2m bins (the upper half as
conjugate mirrors), frames in natural order. Samples past the signal's
end read as zeros, which is the JAX package's tail padding without the
copy. On a CPU tensor the plain version runs: the frames as one strided
view, the same pack, the einsum m-point FFT and the unpaired unpack.

The JAX package has two kernels: one frame per program for
fft_size = m*128 (1K..16K, hop % 128 == 0), and FBS = 32 frames per
program in interleaved sets for 128/256/512 (`small_frame_supported`).
Here both are one kernel with T = max(1, min(FBS, 2048 // m)) frames per
block; the routing windows stay the JAX package's, so the same inputs
take the kernel in both packages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.algos.split_stockham import stockham_fft_split_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import FORWARD, log2_int
from fftlab_torch.core.window import get_window
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (
    check_aligned,
    check_cuda,
    check_real,
    on_cpu,
    stream_of,
)
from fftlab_torch.kernels.fft_vmem import N1, _device_twiddle, supported_size
from fftlab_torch.kernels.rfft_vmem import _pair_twiddle, herm_unpack_plain

FBS = 32  # frames per program of the JAX small-frame kernel

# Complex points in one block's tile: T frames of m = fft_size/2 points.
FRAME_TILE = 2048

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"stft_frames": 0}


def small_frame_supported(fft_size: int, hop: int) -> bool:
    """The JAX small-frame window: fft_size 128/256/512 with a hop of
    whole 128-sample rows that divides the frame."""
    if fft_size % N1 or hop % N1 or hop <= 0 or hop > fft_size:
        return False
    m = fft_size // N1
    return m in (1, 2, 4) and m % (hop // N1) == 0


def kernel_supported(fft_size: int, hop: int) -> bool:
    """The frame sizes and hops that take the kernel: supported_size with
    hop % 128 == 0, or the small-frame window (stft.py:185-187)."""
    return ((supported_size(fft_size) and hop > 0 and hop % N1 == 0)
            or small_frame_supported(fft_size, hop))


def frames_per_block(fft_size: int) -> int:
    """T: frames of one block's tile."""
    return max(1, min(FBS, FRAME_TILE // (fft_size // 2)))


@functools.lru_cache(maxsize=16)
def _named_window(name: str, fft_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_window(name, fft_size).astype(np.float32)).to(device)


def window_table(window, fft_size: int, device: torch.device) -> torch.Tensor:
    """The window as float32 on `device`, built in float64 by `get_window`
    (cached for a named window)."""
    if isinstance(window, str):
        return _named_window(window, fft_size, device)
    return torch.from_numpy(get_window(window, fft_size).astype(np.float32)).to(device)


def stft_frames_plain(x: torch.Tensor, fft_size: int, hop: int, w: torch.Tensor,
                      n_frames: int, onesided: bool = True):
    """Plain version of `stft_frames`: frames as one strided view of the
    zero-extended signal, windowed, packed, the m-point FFT in tensor
    ops, the unpaired unpack; the two-sided upper half as conjugate
    mirrors."""
    frames = frame_signal_strided(x, fft_size, hop, n_frames) * w
    Zr, Zi = stockham_fft_split_unscaled(frames[..., 0::2], frames[..., 1::2], FORWARD)
    Xr, Xi = herm_unpack_plain(Zr, Zi, fft_size)
    if onesided:
        return Xr, Xi
    m = fft_size // 2
    return (torch.cat([Xr, torch.flip(Xr[..., 1:m], [-1])], dim=-1),
            torch.cat([Xi, -torch.flip(Xi[..., 1:m], [-1])], dim=-1))


def stft_frames(x: torch.Tensor, fft_size: int, hop: int, w: torch.Tensor,
                n_frames: int, onesided: bool = True):
    """Launch `stft_frames` on a contiguous 1D CUDA float32 signal (8-byte
    aligned, hop even): returns (re, im) [n_frames, bins], frame f read
    from x[f*hop : f*hop + fft_size] with zeros past the end."""
    check_real(x, "stft_frames")
    check_real(w, "stft_frames")
    check_cuda(x, w, name="stft_frames")
    check_aligned(x, w, name="stft_frames")
    if x.dim() != 1 or tuple(w.shape) != (fft_size,):
        raise ValueError(f"stft_frames takes a 1D signal and a ({fft_size},) "
                         f"window; got {tuple(x.shape)}, {tuple(w.shape)}")
    if hop <= 0 or hop % 2 or n_frames < 1:
        raise ValueError(f"stft_frames reads frames as float2 pairs and needs an "
                         f"even hop and a frame; got hop={hop}, n_frames={n_frames}")
    m = fft_size // 2
    log_m = log2_int(m)
    bins = m + 1 if onesided else fft_size
    yr = torch.empty(n_frames, bins, device=x.device)
    yi = torch.empty_like(yr)
    tw = _device_twiddle(m, FORWARD, x.device)
    utw = _pair_twiddle(fft_size, FORWARD, x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.fftlab_stft_frames(
            x.data_ptr(), x.numel(), w.data_ptr(), tw.data_ptr(), utw.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), n_frames, hop, log_m,
            log2_int(frames_per_block(fft_size)), bins, stream_of(x))
    _build.check(lib, "stft_frames", rc)
    LAUNCHES["stft_frames"] += 1
    return yr, yi


def stft_frames_auto(x: torch.Tensor, fft_size: int, hop: int, window,
                     n_frames: int, onesided: bool = True):
    """`n_frames` windowed frames' spectra of a real 1D signal: the kernel
    on a CUDA tensor, its plain version on a CPU tensor."""
    w = window_table(window, fft_size, x.device)
    run = stft_frames_plain if on_cpu(x, "stft_frames") else stft_frames
    return run(x, fft_size, hop, w, n_frames, onesided)


def pallas_stft_split(x: torch.Tensor, fft_size: int = 2048, hop: int = 512,
                      window="hann", onesided: bool = True):
    """Streaming STFT of a real float32 1D signal -> (re, im) spectra
    [n_frames, bins] without a frame tensor. The signal's tail is padded
    with zeros to a multiple of 128, and frames start at k*hop for
    k < (padded length - fft_size)//hop + 1, as in the JAX package
    (stft_vmem.py:209-229)."""
    check_real(x, "pallas_stft_split")
    if x.dim() != 1:
        raise ValueError(f"pallas_stft_split expects a 1D signal, got {tuple(x.shape)}")
    small = small_frame_supported(fft_size, hop)
    if not supported_size(fft_size) and not small:
        raise ValueError(
            f"fft_size must be m*128, m in 8..128 pow2 (or 1/2/4 with "
            f"hop dividing the frame); got {fft_size} (hop {hop})")
    if hop % N1 or hop <= 0:
        raise ValueError(f"hop must be a positive multiple of {N1}; got {hop}")
    n = -(-int(x.shape[-1]) // N1) * N1
    if n < fft_size:
        raise ValueError(f"signal ({n}) shorter than fft_size ({fft_size})")
    return stft_frames_auto(x, fft_size, hop, window, (n - fft_size) // hop + 1,
                            onesided)
