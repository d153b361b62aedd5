"""Power-spectrum demo: periodogram vs Welch on a noisy two-tone signal,
spectral statistics, the autocorrelation peak, and the magnitude-squared
coherence of a delayed noisy copy."""

from __future__ import annotations

import argparse

import numpy as np

from fftlab_torch.cli import parse
from fftlab_torch.core.types import to_host
from fftlab_torch.dsp.spectrum import (autocorrelation, coherence, periodogram,
                                       spectral_stats, welch_psd)
from fftlab_torch.utils.plotting import ascii_spectrum
from fftlab_torch.utils.signals import generate_multi_tone, generate_noise


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--fs", type=float, default=1024.0)
    args = parse(ap)
    dev = args.device

    n, fs = args.n, args.fs
    x = generate_multi_tone(n, [64.0, 200.0], [1.0, 0.5], fs)
    x = x + 0.2 * generate_noise(n, seed=7)

    freqs, p = periodogram(x[:1024], sample_rate=fs, device=dev)
    print("periodogram (one 1024-pt segment):")
    print(ascii_spectrum(to_host(p), 16, 40, freqs, db=True))

    freqs, pw = welch_psd(x, sample_rate=fs, window_size=512, overlap=0.5, device=dev)
    print("\nWelch PSD (512-pt segments, 50% overlap — variance reduced):")
    print(ascii_spectrum(to_host(pw), 16, 40, freqs, db=True))

    stats = spectral_stats(pw, freqs)
    print(f"\nspectral stats: centroid {stats['centroid']:.1f} Hz, "
          f"bandwidth {stats['bandwidth']:.1f} Hz, "
          f"95% rolloff {stats['rolloff_95']:.1f} Hz")

    r = to_host(autocorrelation(x, device=dev))
    lag = int(np.argmax(r[8:256])) + 8
    print(f"autocorrelation: first major peak at lag {lag} "
          f"(~{fs/lag:.1f} Hz periodicity)")

    # coherence: y = x delayed + independent noise -> high at the tones
    y = np.roll(x, 5) + 0.5 * generate_noise(n, seed=8)
    _, c = coherence(x, y, sample_rate=fs, window_size=512, device=dev)
    k64 = int(64.0 * 512 / fs)
    print(f"coherence at 64 Hz: {float(to_host(c)[k64]):.2f} "
          f"(reference's placeholder would say 1.0 everywhere)")


if __name__ == "__main__":
    main()
