"""Short-time Fourier transform, its inverse and the spectrogram
(counterpart of fftlab/dsp/stft.py).

Frames start at k*hop over the zero-extended signal with ceil framing,
n_frames = ceil((n - fft_size)/hop) + 1, so the tail is kept rather than
dropped. The complex-dtype `stft`, `stft_complex`, `istft` and
`spectrogram` frame the signal as one strided view and transform the
frames as a batch through `rfft`/`irfft` or `cfft` (the tensor-op
Stockham by default); input that is not a tensor goes to the card unless
the caller passes `device="cpu"`. On split planes, where (fft_size, hop)
is in the kernel window (kernels/stft_vmem.kernel_supported) `stft_split`
runs the `stft_frames` kernel on a CUDA tensor and its plain version on
a CPU tensor; other sizes frame the signal and run the einsum route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.algos._common import table_on
from fftlab_torch.algos.real_fft import irfft, rfft
from fftlab_torch.algos.split_stockham import fft_split, stockham_fft_split_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import (FORWARD, INVERSE, as_tensor, complex_dtype_for,
                                     real_dtype_for)
from fftlab_torch.core.window import get_window
from fftlab_torch.kernels._common import check_planes, check_real
from fftlab_torch.kernels.stft_vmem import (kernel_supported, stft_frames_auto,
                                            window_table)


def _ceil_frames(n: int, frame_size: int, hop: int) -> int:
    return max(-(-max(n - frame_size, 0) // hop) + 1, 1)


def frame_signal(x: torch.Tensor, frame_size: int, hop: int, pad: bool = True):
    """[..., n] -> [..., n_frames, frame_size]: ceil framing over the
    zero-extended signal (pad=True) or only whole frames (pad=False)."""
    n = int(x.shape[-1])
    n_frames = (_ceil_frames(n, frame_size, hop) if pad
                else (n - frame_size) // hop + 1)
    return frame_signal_strided(x, frame_size, hop, n_frames)


def window_tensor(window, n: int, like: torch.Tensor) -> torch.Tensor:
    """`get_window(window, n)` as a tensor of `like`'s real dtype on its
    device; a named window is built once per (name, n, dtype, device), as
    the JAX package embeds it as a constant when it traces."""
    dtype = real_dtype_for(like.dtype)
    if isinstance(window, str):
        return table_on(get_window, window, n, dtype=dtype, device=like.device)
    return torch.from_numpy(np.asarray(get_window(window, n))).to(device=like.device,
                                                                  dtype=dtype)


def stft(x, fft_size: int = 2048, hop: int = 512, window="hann", cfft=None,
         device="cuda"):
    """Real-input STFT: [..., n] -> complex [..., n_frames, fft_size//2+1],
    the windowed frames through `rfft`."""
    frames = frame_signal(as_tensor(x, device), fft_size, hop)
    return rfft(frames * window_tensor(window, fft_size, frames), cfft)


def stft_complex(x, fft_size: int = 2048, hop: int = 512, window="hann", cfft=None,
                 device="cuda"):
    """STFT returning the full fft_size spectrum of each frame: [..., n]
    (real or complex) -> complex [..., n_frames, fft_size]."""
    if cfft is None:
        from fftlab_torch.algos.stockham import stockham_fft as cfft
    frames = frame_signal(as_tensor(x, device), fft_size, hop)
    w = window_tensor(window, fft_size, frames)
    return cfft((frames * w).to(complex_dtype_for(frames.dtype)), FORWARD)


def istft(S, fft_size: int = 2048, hop: int = 512, window="hann",
          length: int | None = None, cfft=None, device="cuda"):
    """Inverse STFT by windowed overlap-add with COLA normalization:
    complex [..., n_frames, fft_size//2+1] -> real [..., length], the
    frames through `irfft`. Where the summed window energy is about 0
    (the first and last samples under a Hann window) the division by its
    1e-10 floor does not give the signal back."""
    S = as_tensor(S, device)
    frames = irfft(S, n=fft_size, cfft=cfft)
    frames = frames * window_tensor(window, fft_size, frames)
    out = _cola_overlap_add(frames, np.asarray(get_window(window, fft_size)), fft_size, hop)
    return out if length is None else out[..., :length]


def ema_frames(mag: torch.Tensor, averaging: int) -> torch.Tensor:
    """The exponential average over frames of [..., T, bins]:
    c_t = (1 - a) c_{t-1} + a m_t with a = 1/averaging and c_{-1} = m_0,
    all T outputs, as a doubling scan. With b_0 = m_0 and b_t = a m_t,
    c_t = sum_s (1-a)^(t-s) b_s, and log2(T) steps y_t += (1-a)^k y_{t-k},
    k = 1, 2, 4, ..., build it: a few whole-tensor operations a step,
    where a loop over frames would launch per frame."""
    if averaging <= 1:
        return mag
    alpha = 1.0 / averaging
    y = mag * alpha
    y[..., :1, :] = mag[..., :1, :]
    T = int(mag.shape[-2])
    k = 1
    while k < T:
        y[..., k:, :] = y[..., k:, :] + (1.0 - alpha) ** k * y[..., :-k, :]
        k *= 2
    return y


def spectrogram(x, fft_size: int = 2048, hop: int = 512, window="hann",
                averaging: int = 1, cfft=None, device="cuda"):
    """Magnitude spectrogram [..., n_frames, fft_size//2+1], with the
    exponential frame average of `ema_frames` when averaging > 1."""
    return ema_frames(stft(x, fft_size, hop, window, cfft, device).abs(), averaging)


def _cola_overlap_add(frames: torch.Tensor, w: np.ndarray, fft_size: int, hop: int):
    """Windowed overlap-add: [..., n_frames, fft_size] ->
    [..., (n_frames-1)*hop + fft_size], divided by the summed window
    energy (floored at 1e-10). Each frame splits into q = ceil(fft_size/hop)
    hop-chunks and the sum runs over the q diagonal shifts, not over the
    frames; the JAX package does that where hop divides fft_size and
    loops over frames otherwise, the same sum in another order."""
    n_frames = int(frames.shape[-2])
    batch = tuple(frames.shape[:-2])
    total = (n_frames - 1) * hop + fft_size
    q = -(-fft_size // hop)
    f3 = F.pad(frames, (0, q * hop - fft_size)).reshape(*batch, n_frames, q, hop)
    out = frames.new_zeros(*batch, n_frames + q - 1, hop)
    # the window energy in float64 on the frames' device, as the JAX
    # package sums it in float64 on the host
    w2 = np.zeros(q * hop)
    w2[:fft_size] = w * w
    w2 = torch.from_numpy(w2.reshape(q, hop)).to(out.device)
    norm = torch.zeros(n_frames + q - 1, hop, dtype=torch.float64, device=out.device)
    for j in range(q):
        out[..., j:j + n_frames, :] += f3[..., :, j, :]
        norm[j:j + n_frames] += w2[j]
    out = out.reshape(*batch, -1)[..., :total]
    norm = torch.clamp_min(norm.reshape(-1)[:total], 1e-10)
    return out / norm.to(out.dtype)


def stft_split(x: torch.Tensor, fft_size: int = 2048, hop: int = 512,
               window="hann", onesided: bool = True):
    """STFT of a real float32 1D signal on split planes: (re, im) of
    [n_frames, bins] with bins = fft_size//2+1 (onesided) or fft_size,
    n_frames = ceil((n - fft_size)/hop) + 1. Another dtype is refused,
    not cast."""
    check_real(x, "stft_split")
    if x.dim() != 1:
        raise ValueError(f"stft_split expects a 1D signal, got {tuple(x.shape)}")
    n = int(x.shape[-1])
    n_frames = _ceil_frames(n, fft_size, hop)
    if kernel_supported(fft_size, hop):
        return stft_frames_auto(x, fft_size, hop, window, n_frames, onesided)
    frames = frame_signal_strided(x, fft_size, hop, n_frames)
    fr = frames * window_table(window, fft_size, x.device)
    Xr, Xi = stockham_fft_split_unscaled(fr, torch.zeros_like(fr), FORWARD)
    bins = fft_size // 2 + 1 if onesided else fft_size
    return Xr[..., :bins], Xi[..., :bins]


def istft_split(Sr: torch.Tensor, Si: torch.Tensor, fft_size: int = 2048,
                hop: int = 512, window="hann", length: int | None = None):
    """Inverse STFT on split planes: one-sided (re, im) float32 spectra
    [n_frames, fft_size//2+1] -> real [total], windowed overlap-add with
    COLA normalization. The frames' inverse is the Hermitian extension
    through `fft_split`, as in the JAX package."""
    check_planes(Sr, Si, "istft_split")
    if Sr.dim() != 2:
        raise ValueError(f"istft_split expects [n_frames, bins], got {tuple(Sr.shape)}")
    if fft_size % 2:
        raise ValueError(
            f"istft_split needs even fft_size (the Hermitian extension "
            f"assumes a Nyquist bin); got {fft_size}")
    h = fft_size // 2 + 1
    if int(Sr.shape[-1]) != h:
        raise ValueError(f"expected {h} one-sided bins for fft_size {fft_size}; "
                         f"got {Sr.shape[-1]}")
    fr = torch.cat([Sr, torch.flip(Sr[:, 1:h - 1], [-1])], dim=-1)
    fi = torch.cat([Si, -torch.flip(Si[:, 1:h - 1], [-1])], dim=-1)
    yr, _ = fft_split(fr, fi, INVERSE)
    w = np.asarray(get_window(window, fft_size))
    frames = yr * torch.from_numpy(w).to(device=yr.device, dtype=yr.dtype)
    out = _cola_overlap_add(frames, w, fft_size, hop)
    return out if length is None else out[:length]
