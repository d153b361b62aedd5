"""Streaming spectrum analyzer demo: a frequency sweep with harmonics
fed through the analyzer in chunks of four hops, one ASCII spectrum and
its three strongest peaks per chunk. `--frames N` limits the output;
`--live` clears the screen between frames."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from fftlab_torch.algos.real_fft import rfftfreq
from fftlab_torch.cli import parse
from fftlab_torch.dsp.analyzer import AnalyzerConfig, RealtimeAnalyzer
from fftlab_torch.utils.plotting import ansi_clear, ascii_spectrum


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--fft-size", type=int, default=2048)
    ap.add_argument("--hop", type=int, default=512)
    ap.add_argument("--wav", default=None,
                    help="analyze a WAV file instead of the synthetic sweep (not "
                         "ported yet: exits non-zero)")
    args = parse(ap)

    if args.wav:
        sys.exit("analyzer --wav: the WAV reader (fftlab.native.wav) is not ported "
                 "yet (ROADMAP Queue 1 item 13)")
    cfg = AnalyzerConfig(fft_size=args.fft_size, hop=args.hop)
    # a time-varying signal: a sweeping fundamental and fixed harmonics
    total = args.frames * cfg.hop * 4
    fs = cfg.sample_rate
    t = np.arange(total) / fs
    f0 = 440.0 + 400.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    sig = (np.sin(phase) + 0.5 * np.sin(2 * phase)
           + 0.25 * np.sin(3 * phase)).astype(np.float32)

    an = RealtimeAnalyzer(cfg, device=args.device)
    freqs = rfftfreq(cfg.fft_size, 1.0 / cfg.sample_rate)

    shown = 0
    for i in range(0, total, cfg.hop * 4):
        avg = an.process(sig[i : i + cfg.hop * 4])
        if avg is None:
            continue
        header = ansi_clear() if args.live else f"\n--- frame {shown} ---\n"
        print(header + ascii_spectrum(avg[: len(avg) // 8], n_bins=24,
                                      width=48, freqs=freqs))
        for p in an.peaks()[:3]:
            print(f"  peak {p.freq:8.1f} Hz  {p.note:<4} "
                  f"({p.cents:+.0f} cents)  mag {p.magnitude:.2f}")
        shown += 1
        if shown >= args.frames:
            break


if __name__ == "__main__":
    main()
