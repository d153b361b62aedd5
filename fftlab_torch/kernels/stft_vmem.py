"""Streaming STFT of a real 1D signal without a frame tensor (counterpart
of fftlab/kernels/stft_vmem.py).

Frame f of fft_size = 2m points starts at f*hop. On a CUDA tensor the
hand-written kernel `stft_frames` (csrc/real.cu) runs, one block per T
consecutive frames: it reads the frames' span of the signal once into
shared memory in 16-byte words (`stft_layout`), runs the m-point FFT of
each windowed, packed frame z[j] = x[2j] + i*x[2j+1] on the register
engine (csrc/fft_reg.cuh), unpacks bins 0..m (one-sided) or all 2m bins
(the upper half as conjugate mirrors) into a staging area laid out as
the block's T output rows, and stores those rows as one contiguous run
per plane, frames in natural order. Samples past the signal's end read
as zeros, which is the JAX package's tail padding without the copy. On a
CPU tensor the plain version runs: the frames as one strided view, the
same pack, the einsum m-point FFT and the unpaired unpack.

The JAX package has two kernels: one frame per program for
fft_size = m*128 (1K..16K, hop % 128 == 0), and FBS = 32 frames per
program in interleaved sets for 128/256/512 (`small_frame_supported`).
Here both are one kernel with T = `frames_per_block(fft_size)` frames
per block; the routing windows stay the JAX package's, so the same
inputs take the kernel in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fftlab_torch.algos.split_stockham import stockham_fft_split_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import FORWARD, log2_int
from fftlab_torch.core.window import get_window
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (
    TileGeometry,
    check_aligned,
    check_cuda,
    check_real,
    on_cpu,
    stream_of,
    tile_geometry,
)
from fftlab_torch.kernels.fft_vmem import N1, _engine_twiddle, supported_size
from fftlab_torch.kernels.rfft_vmem import _pair_twiddle, herm_unpack_plain
from fftlab_torch.utils import trace

FBS = 32  # frames per program of the JAX small-frame kernel

# Complex points in one block's tile: T frames of m = fft_size/2 points.
FRAME_TILE = 2048
# The kernel's limits (csrc/real.cu fftlab_stft_frames): m in 64..8192,
# T*m <= 4096 values where T > 1, one frame per block above m = 1024.
MIN_M, MAX_M, MAX_TILE, MAX_TILED_M = 64, 8192, 4096, 1024

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


def span_at(u):
    """Where float u of a signal segment sits in shared memory: four pad
    floats after every 32 (the kernel's addressing, csrc/real.cu
    `span_at`)."""
    return u + 4 * (u >> 5)


@dataclasses.dataclass(frozen=True)
class StftLayout:
    """The shared memory of one `stft_frames` block, in floats, which the
    kernel takes as it is given (csrc/real.cu `StftLayout`; C only checks
    it, `valid_layout`): the engine's exchange planes from 0, then `nseg`
    segments of the signal at `span`, `seg_pitch` floats apart (one
    segment, the block's span of (T-1)*hop + fft_size samples, where
    hop <= fft_size; one per frame above), each read as `words` 16-byte
    words from the one that holds its first sample, then the window at
    `window`. After the FFT the staging area overlays them from 0: two
    planes (re, im) of `stage_pitch` floats."""
    nseg: int
    words: int
    seg_pitch: int
    span: int
    window: int
    stage_pitch: int
    total: int

    def c_struct(self) -> _build.StftLayout:
        return _build.StftLayout(*dataclasses.astuple(self))


@trace.table_cache(maxsize=64)
def stft_layout(m: int, hop: int, T: int, stride: int, bins: int) -> StftLayout:
    """The layout of a block of T frames of m pairs at `hop`, `bins`
    floats out per frame, planes of `stride` (`StftLayout`)."""
    fft_size = 2 * m
    nseg = 1 if hop <= fft_size else T
    seg_len = (T - 1) * hop + fft_size if nseg == 1 else fft_size
    words = (seg_len + 6) // 4  # a lead of up to 3 floats before the first sample
    seg_pitch = (span_at(4 * words) + 3) & ~3
    span = 2 * T * stride
    window = span + nseg * seg_pitch
    stage_pitch = (T * bins + 6) & ~3
    return StftLayout(nseg, words, seg_pitch, span, window, stage_pitch,
                      max(window + fft_size, 2 * stage_pitch))


@trace.table_cache(maxsize=64)
def stft_geometry(fft_size: int, hop: int, T: int, bins: int) -> TileGeometry:
    """The launch of `stft_frames`: the engine's tile of T frames of
    m = fft_size/2 points (one frame a row, swizzled, above m = 1024;
    padded planes of T >= 2 frames below), its shared memory the whole
    `stft_layout`."""
    m = fft_size // 2
    if not (MIN_M <= m <= MAX_M) or m & (m - 1) or T & (T - 1):
        raise ValueError(f"stft_frames takes pow2 fft_size in [{2 * MIN_M}, {2 * MAX_M}] "
                         f"and pow2 T; got {fft_size}, T={T}")
    if (T == 1) != (m > MAX_TILED_M) or (T > 1 and T * m > MAX_TILE) or T * m < 512:
        raise ValueError(f"stft_frames runs one frame per block above fft_size "
                         f"{2 * MAX_TILED_M} and 512..{MAX_TILE} values per block below; "
                         f"got fft_size {fft_size}, T={T}")
    geo = tile_geometry(m, T)
    lay = stft_layout(m, hop, T, geo.stride, bins)
    return dataclasses.replace(geo, smem=4 * lay.total)


@trace.table_cache(maxsize=16)
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
    return _launch_stft(x, fft_size, hop, w, n_frames, onesided,
                        frames_per_block(fft_size), LAUNCHES)


def _launch_stft(x, fft_size: int, hop: int, w, n_frames: int, onesided: bool,
                 T: int, counts: dict):
    """Launch `stft_frames` at T frames per block on checked tensors; the
    launch adds one to `counts["stft_frames"]` (LAUNCHES, or the counts of
    chip_smoke.py's A/B of T)."""
    rec = trace.on()
    t0 = rec and trace.now()
    m = fft_size // 2
    bins = m + 1 if onesided else fft_size
    geo = stft_geometry(fft_size, hop, T, bins)
    lay = stft_layout(m, hop, T, geo.stride, bins)
    yr = torch.empty(n_frames, bins, device=x.device)
    yi = torch.empty_like(yr)
    tw = _engine_twiddle(m, FORWARD, x.device)
    utw = _pair_twiddle(fft_size, FORWARD, x.device)
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.fftlab_stft_frames(
            x.data_ptr(), x.numel(), w.data_ptr(), tw.data_ptr(), utw.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), n_frames, hop, log2_int(m), log2_int(T), bins,
            geo.c_struct(), lay.c_struct(), stream_of(x))
    _build.check(lib, "stft_frames", rc)
    counts["stft_frames"] += 1
    if rec:
        trace.launch_call("stft_frames", t0, t3, trace.now())
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
