"""Utilities the DSP demos print through: test-signal generators and
ASCII plots, numpy only (counterpart of part of fftlab/utils; `io`,
`metrics`, `trace` and `viz` are not ported yet, ROADMAP Queue 1
item 13)."""

from fftlab_torch.utils.plotting import ansi_clear, ascii_image, ascii_spectrum
from fftlab_torch.utils.signals import (
    frequency_shift,
    generate_chirp,
    generate_complex_noise,
    generate_cosine,
    generate_dc,
    generate_impulse,
    generate_multi_tone,
    generate_noise,
    generate_sine,
    generate_square,
    zero_pad,
)
