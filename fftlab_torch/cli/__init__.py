"""The demos, each a module with a `main()` run as
`python -m fftlab_torch.cli.<demo>` (counterpart of fftlab/cli):

  features     a tour: algorithm selection, plans, split plans, the
               hardware report and the teaching visualizers
  benchmark    the cross-algorithm benchmark table (`bench/harness.py`)
  bigfft       the split routes by size, the two-pass kernels at 2^20 and
               a split FFT convolution
  serve        WAV in -> the native ring -> `FilterPlan.stream` -> WAV out
  spectrum     periodogram, Welch, spectral statistics, autocorrelation
               and coherence of a noisy two-tone signal
  convolution  direct vs FFT vs overlap-save/overlap-add vs circular
  filter       low-, high- and band-pass FFT filters on a multi-tone signal
  image        2-D test patterns, their spectra, blur and edge detection
  pitch        the three pitch detectors and the tuner on test tones
  analyzer     the streaming spectrum analyzer on a frequency sweep or a
               WAV file
  dist_demo    the sharded pipelines over a mesh of ranks (`--ranks`,
               `--backend`; or under torchrun)

Each takes its JAX demo's arguments and `--device` (default `cuda`): the
demos run on the card and raise without one unless `--device cpu` is
given; nothing falls back to the CPU.
"""

import argparse

from fftlab_torch.core.types import require_device


def parse(ap: argparse.ArgumentParser, argv: list[str] | None = None) -> argparse.Namespace:
    """The demo's arguments and `--device` (from `argv`, by default the
    command line), checked before any work."""
    ap.add_argument("--device", default="cuda",
                    help='where the demo runs: "cuda" (the default; raises without '
                         'a card) or "cpu"')
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    return args
