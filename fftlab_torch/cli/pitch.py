"""Pitch detection and tuner demo: the three detectors (spectral peak,
HPS, autocorrelation) on tones with harmonics, with the combined
estimate, its note and its offset in cents."""

from __future__ import annotations

import argparse

from fftlab_torch.cli import parse
from fftlab_torch.dsp.pitch import detect_pitch
from fftlab_torch.utils.signals import generate_multi_tone


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--freqs", default="110,220,261.63,440,446")
    ap.add_argument("--fs", type=float, default=8192.0)
    ap.add_argument("--n", type=int, default=4096)
    args = parse(ap)

    print(f"{'true Hz':>9} {'est Hz':>9} {'note':<5} {'cents':>7} "
          f"{'conf':>5}  estimates (peak/HPS/autocorr)")
    for f in (float(s) for s in args.freqs.split(",")):
        # a tone with harmonics, like a plucked string
        x = generate_multi_tone(args.n, [f, 2 * f, 3 * f], [1.0, 0.5, 0.25], args.fs)
        r = detect_pitch(x, args.fs, device=args.device)
        ests = "/".join(f"{e:.1f}" for e in r["estimates"])
        print(f"{f:>9.2f} {r['pitch']:>9.2f} {r['note']:<5} "
              f"{r['cents']:>+7.1f} {r['confidence']:>5.2f}  {ests}")


if __name__ == "__main__":
    main()
