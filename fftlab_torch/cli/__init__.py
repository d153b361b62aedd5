"""The DSP demos, each a module with a `main()` run as
`python -m fftlab_torch.cli.<demo>` (counterpart of fftlab/cli):

  spectrum     periodogram, Welch, spectral statistics, autocorrelation
               and coherence of a noisy two-tone signal
  convolution  direct vs FFT vs overlap-save/overlap-add vs circular
  filter       low-, high- and band-pass FFT filters on a multi-tone signal
  image        2-D test patterns, their spectra, blur and edge detection
  pitch        the three pitch detectors and the tuner on test tones
  analyzer     the streaming spectrum analyzer on a frequency sweep

Each takes its JAX demo's arguments and `--device` (default `cuda`): the
demos run on the card and raise without one unless `--device cpu` is
given; nothing falls back to the CPU. The other demos of fftlab/cli
(`benchmark`, `bigfft`, `features`, `serve`, `dist_demo`) are not
ported yet (ROADMAP Queue 1 item 13).
"""

import argparse

from fftlab_torch.core.types import require_device


def parse(ap: argparse.ArgumentParser) -> argparse.Namespace:
    """The demo's arguments and `--device`, checked before any work."""
    ap.add_argument("--device", default="cuda",
                    help='where the demo runs: "cuda" (the default; raises without '
                         'a card) or "cpu"')
    args = ap.parse_args()
    args.device = require_device(args.device)
    return args
