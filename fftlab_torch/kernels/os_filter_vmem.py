"""Causal FIR filtering by overlap-save (counterpart of
fftlab/kernels/os_filter_vmem.py:249-304).

y = convolve(x, h)[:n] on each plane of split [..., n] planes, real taps
h. Frames of `fft_size` points start every hop = fft_size - (nh - 1)
samples, each preceded by its nh - 1 samples of history (the halo); each
frame goes through the FFT -> H -> IFFT sandwich, and its last hop
samples are the valid output.

On a CUDA tensor the hand-written kernel `os_filter` (csrc/filter.cu)
runs on the register engine of csrc/fft_reg.cuh: each block takes T =
`frames_per_block(fft_size)` consecutive frames of one channel (4096/
fft_size up to 2K frames, one from 4K), its first pass reads them
straight from the signal (zero outside it), it runs the sandwich of each
frame (the forward transform's spectrum left in the exchange planes,
the inverse reading it times H) and stores outputs halo..fft_size-1 of
every frame straight to the output, one contiguous run of T*hop samples
per plane. On a CPU tensor the plain version runs: the same frames as
one strided view, the plain row sandwich, the valid slices.
The JAX kernels round the halo up to whole 128-lane rows and batch
frames per program (FFTLAB_OS_ALIGNED, FFTLAB_OS_FRAMES) for their DMA
layout; neither changes the output, and neither exists here.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import Direction, log2_int
from fftlab_torch.kernels import _build
from fftlab_torch.kernels._common import (
    TileGeometry,
    check_cuda,
    check_planes,
    check_response,
    frame_geometry,
    on_cpu,
    rows_of,
    stream_of,
    tile_geometry,
)
from fftlab_torch.kernels.fft_vmem import (
    N1,
    _engine_twiddle,
    spectral_filter_rows_plain,
    supported_size,
)
from fftlab_torch.utils import trace

# The largest frame the row sandwich takes (fft_vmem.supported_size).
MAX_FFT_SIZE = 16384
# Points of one block's frames up to 2K frames, and the most the kernel
# takes there (csrc/filter.cu `os_threads`): 4096 beat 8192 by 9% at 1K
# frames (chip_smoke.py's A/B of T); from 4K frames (ONE_FRAME) one frame
# a block (`kLogOneFrame`).
FRAME_TILE, MAX_TILE, ONE_FRAME = 4096, 8192, 4096

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = {"os_filter": 0}


def taps_fit(nh: int, fft_size: int) -> bool:
    """The JAX package's size rule: the halo, counted in whole 128-sample
    rows, must leave at least one row of the frame for output."""
    return -(-(nh - 1) // N1) < fft_size // N1


def os_response_np(h: np.ndarray, fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """H = FFT of the zero-padded float64 taps, as float32 (re, im) planes
    in natural bin order."""
    h = np.asarray(h, dtype=np.float64)
    H = np.fft.fft(np.pad(h, (0, fft_size - h.shape[-1])))
    return H.real.astype(np.float32), H.imag.astype(np.float32)


@trace.table_cache(maxsize=16)
def _cached_response(h_bytes: bytes, fft_size: int, device: torch.device):
    hr, hi = os_response_np(np.frombuffer(h_bytes, dtype=np.float64), fft_size)
    return torch.from_numpy(hr).to(device), torch.from_numpy(hi).to(device)


def os_filter_plain(xr: torch.Tensor, xi: torch.Tensor, hr: torch.Tensor,
                    hi: torch.Tensor, nh: int):
    """Plain version of `os_filter` on [C, n] planes; hr, hi: the
    fft_size-bin response of the taps."""
    C, n = xr.shape
    fft_size = int(hr.shape[-1])
    halo = nh - 1
    hop = fft_size - halo
    n_blocks = -(-n // hop)

    def frames(x):
        return frame_signal_strided(F.pad(x, (halo, 0)), fft_size, hop, n_blocks)

    yr, yi = spectral_filter_rows_plain(
        frames(xr).reshape(-1, fft_size), frames(xi).reshape(-1, fft_size),
        hr, hi)
    valid = lambda y: y.reshape(C, n_blocks, fft_size)[..., halo:].reshape(
        C, n_blocks * hop)[:, :n]
    return valid(yr), valid(yi)


def frames_per_block(fft_size: int) -> int:
    """T: frames of one block (FRAME_TILE points; one from ONE_FRAME)."""
    return 1 if fft_size >= ONE_FRAME else FRAME_TILE // fft_size


@trace.table_cache(maxsize=64)
def os_geometry(fft_size: int, T: int) -> TileGeometry:
    """The launch of `os_filter`: T frames of fft_size points a block as
    stacked swizzled rows (`frame_geometry`); from ONE_FRAME one frame a
    block, a single swizzled row (`tile_geometry`)."""
    if (fft_size < 512 or fft_size > MAX_FFT_SIZE or fft_size & (fft_size - 1)
            or T < 1 or T & (T - 1) or T * fft_size > max(MAX_TILE, fft_size)
            or (fft_size >= ONE_FRAME and T != 1)):
        raise ValueError(f"os_filter takes pow2 fft_size in [512, {MAX_FFT_SIZE}] and pow2 T "
                         f"with T*fft_size <= {MAX_TILE}, T = 1 from {ONE_FRAME}; "
                         f"got {fft_size}, T={T}")
    return tile_geometry(fft_size, 1) if fft_size >= ONE_FRAME else frame_geometry(fft_size, T)


def os_filter(xr: torch.Tensor, xi: torch.Tensor, hr: torch.Tensor,
              hi: torch.Tensor, nh: int):
    """Launch the overlap-save kernel on contiguous [C, n] CUDA float32
    planes (at any float offset); hr, hi: the fft_size-bin response of
    the nh taps (fft_size pow2 in 512..16384, nh - 1 < fft_size)."""
    check_planes(xr, xi, "os_filter")
    check_cuda(xr, xi, hr, hi, name="os_filter")
    fft_size = int(hr.shape[-1])
    check_response(hr, hi, fft_size, xr, "os_filter")
    if fft_size < 512 or fft_size > MAX_FFT_SIZE or not 0 <= nh - 1 < fft_size:
        raise ValueError(f"os_filter takes pow2 fft_size in [512, {MAX_FFT_SIZE}] "
                         f"and nh <= fft_size; got {fft_size}, nh={nh}")
    return _launch_os(xr, xi, hr, hi, nh, frames_per_block(fft_size), LAUNCHES)


def _launch_os(xr, xi, hr, hi, nh: int, T: int, counts: dict):
    """Launch `os_filter` at T frames per block on checked tensors; the
    launch adds one to `counts["os_filter"]` (LAUNCHES, or the counts of
    chip_smoke.py's A/B of T)."""
    rec = trace.on()
    t0 = rec and trace.now()
    C, n = xr.shape
    fft_size = int(hr.shape[-1])
    halo = nh - 1
    hop = fft_size - halo
    geo = os_geometry(fft_size, T)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tw_fwd = _engine_twiddle(fft_size, Direction.FORWARD, xr.device)
    tw_inv = _engine_twiddle(fft_size, Direction.INVERSE, xr.device)
    t3 = rec and trace.now()
    lib = _build.load_library()
    with torch.cuda.device(xr.device):
        rc = lib.fftlab_os_filter(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw_fwd.data_ptr(), tw_inv.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            C, n, hop, halo, log2_int(fft_size), log2_int(T), geo.c_struct(),
            1.0 / fft_size, stream_of(xr))
    _build.check(lib, "os_filter", rc)
    counts["os_filter"] += 1
    if rec:
        trace.launch_call("os_filter", t0, t3, trace.now())
    return yr, yi


def run_os_filter(xr: torch.Tensor, xi: torch.Tensor, hr: torch.Tensor,
                  hi: torch.Tensor, nh: int):
    """Overlap-save of [..., n] planes with a prepared response: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    n = int(xr.shape[-1])
    C = rows_of(xr.shape)
    run = os_filter_plain if on_cpu(xr, "os_filter") else os_filter
    yr, yi = run(xr.reshape(C, n), xi.reshape(C, n), hr, hi, nh)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


def pallas_os_filter_split(xr: torch.Tensor, xi: torch.Tensor, h,
                           fft_size: int | None = None):
    """Causal FIR filtering of split planes [..., n] by overlap-save: equal
    to convolve(x, h)[:n] on each plane. h: [nh] real taps. Leading dims
    are independent channels. fft_size defaults to the largest frame,
    16384, which reads the signal the fewest times."""
    if xr.shape != xi.shape:
        raise ValueError(f"plane shapes differ: {tuple(xr.shape)} vs {tuple(xi.shape)}")
    check_planes(xr, xi, "pallas_os_filter_split")
    h = np.asarray(h, dtype=np.float64)
    nh = int(h.shape[-1])
    if fft_size is None:
        fft_size = MAX_FFT_SIZE
    if not supported_size(fft_size):
        raise ValueError(f"fft_size must be m*128, m in 8..128 pow2; got {fft_size}")
    if not taps_fit(nh, fft_size):
        raise ValueError(f"taps {nh} too long for fft_size {fft_size}")
    hr, hi = _cached_response(np.ascontiguousarray(h).tobytes(), fft_size,
                              xr.device)
    return run_os_filter(xr, xi, hr, hi, nh)
