"""DSP applications (counterpart of fftlab/dsp): filtering, convolution,
spectrum analysis (periodogram, Welch, correlation, coherence), STFT,
2-D image processing, pitch detection and streaming analysis. Every name
of `fftlab.dsp` is here; input that is not a tensor goes to the card
unless the caller passes `device="cpu"`."""

from fftlab_torch.dsp.analyzer import (
    AnalyzerConfig,
    RealtimeAnalyzer,
    analyze_peaks,
    analyze_spectrum,
    find_peaks,
)
from fftlab_torch.dsp.convolution import (
    circular_convolution,
    convolve2d,
    direct_convolution,
    fft_convolution,
    overlap_add,
    overlap_save,
)
from fftlab_torch.dsp.filtering import FilterParams, FilterType, design_fir, fft_filter
from fftlab_torch.dsp.image import (
    detect_edges,
    highpass_filter_image,
    log_magnitude_spectrum,
    lowpass_filter_image,
)
from fftlab_torch.dsp.pitch import (
    detect_pitch,
    freq_to_note,
    harmonic_product_spectrum,
    pitch_autocorrelation,
    pitch_spectral_peak,
)
from fftlab_torch.dsp.spectrum import (
    autocorrelation,
    autocorrelation_split,
    coherence,
    coherence_split,
    cross_correlation,
    cross_correlation_split,
    periodogram,
    spectral_stats,
    welch_psd,
    welch_psd_split,
)
from fftlab_torch.dsp.stft import istft, istft_split, spectrogram, stft, stft_split
