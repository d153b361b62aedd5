"""Utilities (counterpart of fftlab/utils): test-signal generators, ASCII
plots, metrics, signal file IO, timing spans and profiler traces, and
the teaching visualizers (`viz`). Every name of `fftlab.utils` but the
one of `fftlab.utils.compat`, which moves the JAX demos to the CPU; the
port's demos run on the card or raise."""

from fftlab_torch.utils.io import (
    export_gnuplot_script,
    load_complex_signal,
    load_signal_npz,
    save_complex_signal,
    save_signal_npz,
)
from fftlab_torch.utils.metrics import (
    find_peak_interpolated,
    magnitude,
    max_error,
    phase,
    power_spectrum_bins,
    rms_error,
    snr_db,
)
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
from fftlab_torch.utils.trace import Timer, profiler_trace, span
