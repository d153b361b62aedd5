"""fftlab_torch's DSP applications against the JAX package's: pitch
detection, the spectrum analyzer (the streaming `RealtimeAnalyzer`
included) and the 2-D image filters, each on the same seeded numpy
float32 inputs, the port on the CPU (`device="cpu"`); the port's own
copies of the numpy-only utilities against the originals; and the names
`fftlab_torch.dsp` exports. The CUDA versions are tested on the card by
tests/test_torch_cuda.py.

Gates: pitch estimates within 1e-4 Hz of the JAX package's; the
analyzer's and the image filters' outputs >= 110 dB SNR (linear in the
signal), the averaged spectra >= 100 dB; `find_peaks` gives the same
bins; the analyzer's state (overlap tail and average) agrees after each
chunk of an uneven run; host tables, masks, test signals and ASCII
plots equal the originals exactly. Images stay at most 64 x 64, signals
at most 4096 samples per frame."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.dsp as jx_dsp
import fftlab.dsp.analyzer as jx_an
import fftlab.dsp.image as jx_img
import fftlab.dsp.pitch as jx_pitch
import fftlab.utils.plotting as jx_plot
import fftlab.utils.signals as jx_sig
import fftlab_torch.dsp as pt_dsp
import fftlab_torch.utils as pt_utils
from _torch_parity import snr_db, tt
from fftlab_torch.core.types import to_host
from fftlab_torch.dsp import analyzer as pt_an
from fftlab_torch.dsp import image as pt_img
from fftlab_torch.dsp import pitch as pt_pitch
from fftlab_torch.utils import plotting as pt_plot
from fftlab_torch.utils import signals as pt_sig

FS = 8192.0


def tones(f0s, n: int = 4096, seed: int = 0) -> np.ndarray:
    """Frames [len(f0s), n] of a tone with two harmonics and a little
    noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    out = [np.sin(2 * np.pi * f * t) + 0.5 * np.sin(4 * np.pi * f * t)
           + 0.25 * np.sin(6 * np.pi * f * t) + 0.01 * rng.standard_normal(n)
           for f in f0s]
    return np.asarray(out, np.float32)


# ------------------------------------------------------------------ pitch

def test_note_table_and_freq_to_note_match_jax():
    assert pt_pitch.note_table() == jx_pitch.note_table()
    for f in (0.0, -3.0, 16.35, 27.5, 110.0, 261.63, 440.0, 446.0, 1000.0, 4186.0, 9000.0):
        assert pt_pitch.freq_to_note(f) == jx_pitch.freq_to_note(f)


DETECTORS = {
    "spectral_peak": (pt_pitch.pitch_spectral_peak, jx_pitch.pitch_spectral_peak, {}),
    "spectral_peak_band": (pt_pitch.pitch_spectral_peak, jx_pitch.pitch_spectral_peak,
                           {"fmin": 150.0, "fmax": 900.0, "window": "hamming"}),
    "hps": (pt_pitch.harmonic_product_spectrum, jx_pitch.harmonic_product_spectrum, {}),
    "hps_3": (pt_pitch.harmonic_product_spectrum, jx_pitch.harmonic_product_spectrum,
              {"n_harmonics": 3}),
    "autocorrelation": (pt_pitch.pitch_autocorrelation, jx_pitch.pitch_autocorrelation, {}),
}


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("name", list(DETECTORS))
def test_pitch_detectors_match_jax(name, n):
    pt_fn, jx_fn, kw = DETECTORS[name]
    x = tones([110.0, 220.0, 261.63, 446.0], n, seed=n)
    got = to_host(pt_fn(x, FS, device="cpu", **kw))
    want = np.asarray(jx_fn(jnp.asarray(x), FS, **kw))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_parabolic_refine_matches_jax():
    mag = np.abs(np.random.default_rng(1).standard_normal((3, 50))).astype(np.float32)
    k = np.array([0, 17, 49])
    got = to_host(pt_pitch._parabolic_refine(tt(mag), tt(k)))
    want = np.asarray(jx_pitch._parabolic_refine(jnp.asarray(mag), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("f0", [110.0, 261.63, 440.0])
def test_detect_pitch_matches_jax(f0):
    x = tones([f0])[0]
    got = pt_pitch.detect_pitch(x, FS, device="cpu")
    want = jx_pitch.detect_pitch(jnp.asarray(x), FS)
    assert got.keys() == want.keys()
    assert got["note"] == want["note"] and got["confidence"] == want["confidence"]
    np.testing.assert_allclose(got["estimates"], want["estimates"], rtol=0, atol=1e-4)
    assert got["pitch"] == pytest.approx(want["pitch"], abs=1e-4)
    assert got["cents"] == pytest.approx(want["cents"], abs=1e-3)


# --------------------------------------------------------------- analyzer

def test_bin_freq_conversions_match_jax():
    for k, n, fs in ((0, 2048, 44100.0), (17, 1024, 8000.0), (512.5, 2048, 48000.0)):
        assert pt_an.bin_to_freq(k, n, fs) == jx_an.bin_to_freq(k, n, fs)
        assert pt_an.freq_to_bin(440.0 + k, n, fs) == jx_an.freq_to_bin(440.0 + k, n, fs)


@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_analyze_spectrum_matches_jax(window):
    x = tones([300.0, 1000.0], 2048)
    f_pt, m_pt = pt_an.analyze_spectrum(x, FS, window, device="cpu")
    f_jx, m_jx = jx_an.analyze_spectrum(jnp.asarray(x), FS, window)
    np.testing.assert_array_equal(f_pt, f_jx)
    assert snr_db(to_host(m_pt), np.asarray(m_jx)) >= 110.0


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_find_peaks_gives_the_same_bins(threshold):
    x = tones([300.0], 2048)[0]
    freqs, mag = pt_an.analyze_spectrum(x, FS, device="cpu")
    _, mag_jx = jx_an.analyze_spectrum(jnp.asarray(x), FS)
    got = pt_an.find_peaks(mag, freqs, 8, threshold)  # the tensor, read back
    want = jx_an.find_peaks(np.asarray(mag_jx), freqs, 8, threshold)
    assert [round(p.bin) for p in got] == [round(p.bin) for p in want]
    assert [p.note for p in got] == [p.note for p in want]
    np.testing.assert_allclose([p.freq for p in got], [p.freq for p in want], atol=1e-3)
    # the same host input gives the same peaks exactly
    same = pt_an.find_peaks(np.asarray(mag_jx), freqs, 8, threshold)
    assert [vars(p) for p in same] == [vars(p) for p in want]


def test_analyze_peaks_matches_jax():
    x = tones([261.63, 700.0], 4096)[1]
    got = pt_an.analyze_peaks(x, FS, 6, device="cpu")
    want = jx_an.analyze_peaks(jnp.asarray(x), FS, 6)
    assert [round(p.bin) for p in got] == [round(p.bin) for p in want]
    for a, b in zip(got, want):
        assert a.freq == pytest.approx(b.freq, abs=1e-3)
        assert a.magnitude == pytest.approx(b.magnitude, rel=1e-4)
        assert a.phase == pytest.approx(b.phase, abs=1e-3)
        assert a.note == b.note


def sweep(total: int, fs: float = 44100.0) -> np.ndarray:
    t = np.arange(total) / fs
    phase = 2 * np.pi * np.cumsum(440.0 + 400.0 * np.sin(2 * np.pi * 0.5 * t)) / fs
    return (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)).astype(
        np.float32)


# uneven chunks: shorter than a frame, exactly one, several frames, one sample
CHUNKS = [100, 300, 511, 4096, 7000, 1, 2048, 3333]


@pytest.mark.parametrize("fft_size,hop", [(2048, 512), (512, 128), (400, 100)])
def test_realtime_analyzer_state_matches_jax(fft_size, hop):
    cfg_pt = pt_an.AnalyzerConfig(fft_size=fft_size, hop=hop)
    cfg_jx = jx_an.AnalyzerConfig(fft_size=fft_size, hop=hop)
    a_pt = pt_an.RealtimeAnalyzer(cfg_pt, device="cpu")
    a_jx = jx_an.RealtimeAnalyzer(cfg_jx)
    sig = sweep(sum(CHUNKS))
    at = 0
    for size in CHUNKS:
        chunk = sig[at:at + size]
        at += size
        got, want = a_pt.process(chunk), a_jx.process(chunk)
        np.testing.assert_array_equal(a_pt._tail, a_jx._tail)
        assert (got is None) == (want is None)
        if want is not None:
            assert isinstance(got, np.ndarray) and got.shape == want.shape
            assert snr_db(got, want) >= 100.0
    assert [round(p.bin) for p in a_pt.peaks()] == [round(p.bin) for p in a_jx.peaks()]


@pytest.mark.parametrize("averaging", [1, 4])
@pytest.mark.parametrize("fft_size,hop", [(2048, 512), (512, 128), (300, 100)])
def test_spectrogram_batch_matches_jax(fft_size, hop, averaging):
    sig = sweep(4096)
    got = pt_an.RealtimeAnalyzer(pt_an.AnalyzerConfig(fft_size=fft_size, hop=hop,
                                                      averaging=averaging),
                                 device="cpu").spectrogram_batch(sig)
    want = jx_an.RealtimeAnalyzer(jx_an.AnalyzerConfig(fft_size=fft_size, hop=hop,
                                                       averaging=averaging)
                                  ).spectrogram_batch(sig)
    assert tuple(got.shape) == np.asarray(want).shape
    assert snr_db(to_host(got), np.asarray(want)) >= 100.0


def test_spectrogram_batch_with_a_cfft_takes_the_complex_path():
    from fftlab.algos.stockham import stockham_fft as jx_cfft
    from fftlab_torch.algos.stockham import stockham_fft as pt_cfft

    sig = sweep(4096)
    got = pt_an.RealtimeAnalyzer(pt_an.AnalyzerConfig(fft_size=512, hop=128), pt_cfft,
                                 device="cpu").spectrogram_batch(sig)
    want = jx_an.RealtimeAnalyzer(jx_an.AnalyzerConfig(fft_size=512, hop=128),
                                  jx_cfft).spectrogram_batch(sig)
    assert snr_db(to_host(got), np.asarray(want)) >= 100.0


def test_realtime_analyzer_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt_an.RealtimeAnalyzer()


# ------------------------------------------------------------------ image

GENERATORS = [("generate_2d_sinusoid", (32, 48, 4, 2)),
              ("generate_2d_sinusoid", (16, 16, 1.5, 3, 2.0)),
              ("generate_2d_gaussian", (40, 30, 5.0)),
              ("generate_2d_rect", (32, 32, 8, 12, 3.0))]


@pytest.mark.parametrize("name,args", GENERATORS)
def test_image_generators_equal_the_originals(name, args):
    np.testing.assert_array_equal(getattr(pt_img, name)(*args), getattr(jx_img, name)(*args))


@pytest.mark.parametrize("name", ["ideal_lowpass_mask", "ideal_highpass_mask",
                                  "gaussian_lowpass_mask", "gaussian_highpass_mask"])
@pytest.mark.parametrize("rows,cols,param", [(64, 64, 8.0), (33, 20, 3.5)])
def test_masks_equal_the_originals(name, rows, cols, param):
    np.testing.assert_array_equal(getattr(pt_img, name)(rows, cols, param),
                                  getattr(jx_img, name)(rows, cols, param))


IMAGE_CALLS = {
    "lowpass_ideal": ("lowpass_filter_image", (8.0, "ideal")),
    "lowpass_gaussian": ("lowpass_filter_image", (6.0, "gaussian")),
    "highpass_ideal": ("highpass_filter_image", (8.0, "ideal")),
    "highpass_gaussian": ("highpass_filter_image", (6.0, "gaussian")),
    "edges": ("detect_edges", ()),
    "edges_cutoff": ("detect_edges", (12.0,)),
    "log_magnitude": ("log_magnitude_spectrum", ()),
}


@pytest.mark.parametrize("shape,complex_", [((64, 64), False), ((2, 32, 48), False),
                                            ((32, 32), True)], ids=["64x64", "2x32x48", "c32"])
@pytest.mark.parametrize("case", list(IMAGE_CALLS))
def test_image_filters_match_jax(case, shape, complex_):
    name, args = IMAGE_CALLS[case]
    rng = np.random.default_rng(len(case))
    img = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        img = (img + 1j * rng.standard_normal(shape)).astype(np.complex64)
    got = to_host(getattr(pt_img, name)(img, *args, device="cpu"))
    want = np.asarray(getattr(jx_img, name)(jnp.asarray(img), *args))
    assert got.shape == want.shape and np.iscomplexobj(got) == np.iscomplexobj(want)
    assert snr_db(got, want) >= 110.0


@pytest.mark.parametrize("mask_as", ["numpy", "tensor"])
def test_apply_frequency_mask_matches_jax(mask_as):
    img = np.random.default_rng(5).standard_normal((32, 32)).astype(np.float32)
    mask = jx_img.gaussian_lowpass_mask(32, 32, 4.0)
    got = to_host(pt_img.apply_frequency_mask(img, mask if mask_as == "numpy" else tt(mask),
                                              device="cpu"))
    want = np.asarray(jx_img.apply_frequency_mask(jnp.asarray(img), mask))
    assert snr_db(got, want) >= 110.0


def test_unknown_filter_kind_raises():
    with pytest.raises(ValueError, match="unknown filter kind"):
        pt_img.lowpass_filter_image(np.zeros((8, 8), np.float32), 2.0, "butterworth",
                                    device="cpu")


@pytest.mark.parametrize("name", ["lowpass_filter_image", "highpass_filter_image",
                                  "detect_edges", "log_magnitude_spectrum"])
def test_image_numpy_input_needs_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (2.0,) if "filter" in name else ()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(pt_img, name)(np.zeros((16, 16), np.float32), *args)


# ----------------------------------------------------------- the utilities

SIGNALS = [("generate_sine", (64, 3.0)), ("generate_sine", (100, 50.0, 1000.0, 0.5, 0.3)),
           ("generate_cosine", (64, 5.0)), ("generate_cosine", (90, 7.0, 800.0, 2.0)),
           ("generate_square", (64, 4.0)), ("generate_square", (77, 30.0, 500.0, 1.5)),
           ("generate_impulse", (32, 5)), ("generate_dc", (16, 0.25)),
           ("generate_chirp", (128, 1.0, 20.0)), ("generate_chirp", (128, 10.0, 200.0, 1000.0)),
           ("generate_noise", (64,)), ("generate_noise", (64, 0.5, 7)),
           ("generate_multi_tone", (256, [5.0, 12.0])),
           ("generate_multi_tone", (256, [100.0, 300.0], [1.0, 0.2], 4000.0)),
           ("generate_complex_noise", (32,)), ("generate_complex_noise", (16, 3, (2, 3))),
           ("zero_pad", (np.arange(5.0), 9)),
           ("frequency_shift", (np.arange(8.0), 100.0, 1000.0))]


@pytest.mark.parametrize("name,args", SIGNALS)
def test_signals_equal_the_originals(name, args):
    np.testing.assert_array_equal(getattr(pt_sig, name)(*args), getattr(jx_sig, name)(*args))


def test_zero_pad_refuses_to_shrink():
    with pytest.raises(ValueError, match="cannot pad"):
        pt_sig.zero_pad(np.arange(5.0), 3)


PLOTS = [("ascii_spectrum", (np.abs(np.sin(np.arange(200) / 7.0)),), {}),
         ("ascii_spectrum", (np.abs(np.cos(np.arange(64) / 3.0)), 16, 40),
          {"freqs": np.arange(64) * 10.0}),
         ("ascii_spectrum", (np.abs(np.sin(np.arange(100) / 5.0)) + 1e-3, 24, 30),
          {"freqs": np.arange(100) * 2.5, "db": True}),
         ("ascii_image", (np.outer(np.arange(40.0), np.sin(np.arange(30.0))),), {}),
         ("ascii_image", (np.random.default_rng(0).standard_normal((64, 64)), 48, 16), {}),
         ("ansi_clear", (), {})]


@pytest.mark.parametrize("name,args,kw", PLOTS)
def test_plotting_equals_the_originals(name, args, kw):
    assert getattr(pt_plot, name)(*args, **kw) == getattr(jx_plot, name)(*args, **kw)


@pytest.mark.parametrize("name,bad", [("ascii_spectrum", np.zeros((2, 2))),
                                      ("ascii_image", np.zeros(4))])
def test_plotting_refuses_the_wrong_rank(name, bad):
    with pytest.raises(ValueError):
        getattr(pt_plot, name)(bad)


# ------------------------------------------------------------------ names

def _public(module) -> set:
    return {n for n in dir(module)
            if not n.startswith("_") and not inspect.ismodule(getattr(module, n))}


def test_dsp_exports_every_name_of_fftlab_dsp():
    missing = _public(jx_dsp) - _public(pt_dsp)
    assert not missing


def test_utils_export_the_signal_and_plot_names():
    want = ({n for n in _public(jx_sig) if n.startswith(("generate_", "zero_", "frequency_"))}
            | {"ascii_spectrum", "ascii_image", "ansi_clear"})
    assert not want - _public(pt_utils)
