"""Audio spectrum analysis: windowed spectra, peak finding with note
names, and the streaming analyzer (counterpart of
fftlab/dsp/analyzer.py).

The analyzer's hop loop is a batched STFT: `RealtimeAnalyzer.process`
frames each chunk (with the carried overlap tail) on the device through
`stft_split`, which at the default 2048/512 is one launch of the
`stft_frames` kernel on the card, and the offline `spectrogram_batch`
takes the same path with the doubling-scan average of
`stft.ema_frames`. Peak extraction is a host epilogue on the small
magnitude output. Input that is not a tensor goes to the card unless
the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fftlab_torch.algos.real_fft import rfft, rfftfreq
from fftlab_torch.core.types import as_tensor, require_device, to_host
from fftlab_torch.core.window import get_window
from fftlab_torch.dsp.pitch import freq_to_note
from fftlab_torch.dsp.stft import ema_frames, spectrogram, stft_split, window_tensor


def bin_to_freq(k, n: int, sample_rate: float) -> float:
    return k * sample_rate / n


def freq_to_bin(f, n: int, sample_rate: float) -> int:
    return int(round(f * n / sample_rate))


def _windowed_rfft(x: torch.Tensor, window, cfft):
    n = int(x.shape[-1])
    return get_window(window, n), rfft(x * window_tensor(window, n, x), cfft)


def analyze_spectrum(x, sample_rate: float, window="hann", cfft=None, device="cuda"):
    """One-shot windowed magnitude spectrum of a real frame: (freqs
    [n/2+1] numpy, magnitude [..., n/2+1]) with the coherent-gain
    amplitude correction 2/(n*gain) (a unit sine reads about 1.0), except
    at DC and Nyquist, which have no mirrored twin."""
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    w, X = _windowed_rfft(x, window, cfft)
    cg = float(np.sum(w) / n)
    h = n // 2 + 1
    dbl = np.full(h, 2.0)
    dbl[0] = 1.0
    if n % 2 == 0:
        dbl[-1] = 1.0
    mag = X.abs()
    mag = mag * torch.from_numpy(dbl / (n * cg)).to(device=mag.device, dtype=mag.dtype)
    return rfftfreq(n, 1.0 / sample_rate), mag


@dataclasses.dataclass
class Peak:
    """A spectral peak, interpolated, with its phase and note."""

    freq: float
    magnitude: float
    bin: float
    phase: float = 0.0
    note: str = ""
    cents: float = 0.0


def find_peaks(mag, freqs, num_peaks: int = 5, threshold: float = 0.0,
               phase=None) -> list[Peak]:
    """Local maxima above threshold, parabolic-interpolated, sorted by
    magnitude descending. Host-side on a 1D magnitude (a tensor is read
    back from its device)."""
    m = to_host(mag).astype(np.float64)
    f = to_host(freqs).astype(np.float64)
    n = len(m)
    if n < 3:
        return []
    interior = m[1:-1]
    is_peak = (interior > m[:-2]) & (interior >= m[2:]) & (interior > threshold)
    idx = np.nonzero(is_peak)[0] + 1
    if len(idx) == 0:
        return []
    order = np.argsort(m[idx])[::-1][:num_peaks]
    ph_all = to_host(phase) if phase is not None else None
    peaks = []
    df = f[1] - f[0] if n > 1 else 1.0
    for k in idx[order]:
        a, b, c = m[k - 1], m[k], m[k + 1]
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        delta = float(np.clip(delta, -0.5, 0.5))
        freq = f[k] + delta * df
        name, cents = freq_to_note(freq)
        peaks.append(Peak(freq=float(freq), magnitude=float(b - 0.25 * (a - c) * delta),
                          bin=float(k + delta),
                          phase=float(ph_all[k]) if ph_all is not None else 0.0,
                          note=name, cents=cents))
    return peaks


def analyze_peaks(x, sample_rate: float, num_peaks: int = 5, window="hann",
                  threshold_ratio: float = 0.01, cfft=None, device="cuda") -> list[Peak]:
    """Windowed FFT and peak extraction with note names, the threshold a
    share of the largest magnitude."""
    x = as_tensor(x, device)
    n = int(x.shape[-1])
    _, X = _windowed_rfft(x, window, cfft)
    mag, ph = to_host(X.abs()), to_host(torch.angle(X))
    thr = threshold_ratio * float(mag.max()) if mag.size else 0.0
    return find_peaks(mag, rfftfreq(n, 1.0 / sample_rate), num_peaks, thr, phase=ph)


@dataclasses.dataclass(frozen=True)
class AnalyzerConfig:
    fft_size: int = 2048
    hop: int = 512
    sample_rate: float = 44100.0
    window: str = "hann"
    averaging: int = 4
    num_peaks: int = 5


class RealtimeAnalyzer:
    """Streaming spectrum analyzer. `process(chunk)` frames every hop of
    the chunk (after the carried overlap tail) on `device`, runs one
    batched windowed FFT (`stft_split`), averages the frames' magnitudes
    (c = (1 - a) c + a m, a = 1/averaging) on the host and returns the
    latest average. State: the overlap tail and the average, both numpy.
    `device` is the card unless the caller passes "cpu"; without a card
    the default raises here, not at the first full frame."""

    def __init__(self, config: AnalyzerConfig = AnalyzerConfig(), cfft=None,
                 device="cuda"):
        self.config = config
        self.cfft = cfft
        self.device = require_device(device)
        self._tail = np.zeros(0, dtype=np.float32)
        self._avg: np.ndarray | None = None

    def process(self, chunk) -> np.ndarray | None:
        """Feed samples; returns the averaged magnitude spectrum after the
        newest complete frame, or None until a full frame accumulates."""
        c = self.config
        buf = np.concatenate([self._tail, to_host(chunk).astype(np.float32)])
        if len(buf) < c.fft_size:
            self._tail = buf
            return self._avg
        n_frames = (len(buf) - c.fft_size) // c.hop + 1
        self._tail = buf[n_frames * c.hop:]
        # the cut yields exactly n_frames ceil-framed windows, so no
        # zero-padded frame enters the average
        cut = (n_frames - 1) * c.hop + c.fft_size
        Xr, Xi = stft_split(as_tensor(buf[:cut], self.device), c.fft_size, c.hop, c.window)
        mags = to_host(torch.sqrt(Xr * Xr + Xi * Xi))
        alpha = 1.0 / c.averaging
        avg = self._avg if self._avg is not None else mags[0]
        for m in mags:
            avg = (1 - alpha) * avg + alpha * m
        self._avg = avg
        return avg

    def peaks(self) -> list[Peak]:
        """Tracked peaks of the current averaged spectrum."""
        if self._avg is None:
            return []
        c = self.config
        freqs = rfftfreq(c.fft_size, 1.0 / c.sample_rate)
        return find_peaks(self._avg, freqs, c.num_peaks, 0.01 * float(self._avg.max()))

    def spectrogram_batch(self, signal):
        """The whole signal offline: the magnitude spectrogram [n_frames,
        fft_size//2+1] of `stft_split` with the same average, as a
        doubling scan over frames (`stft.ema_frames`). A custom `cfft`,
        or a batched signal, takes the complex `spectrogram`."""
        c = self.config
        x = as_tensor(signal, self.device).to(torch.float32)
        if self.cfft is not None or x.dim() != 1:
            return spectrogram(x, c.fft_size, c.hop, c.window, c.averaging, self.cfft)
        Xr, Xi = stft_split(x, c.fft_size, c.hop, c.window)
        return ema_frames(torch.sqrt(Xr * Xr + Xi * Xi), c.averaging)
