"""fftlab_torch's complex-dtype DSP against the JAX package's: the
convolutions, the FFT filters, the spectrum estimators and correlations
(the split pair included) and the STFT family, each on the same seeded
numpy float32 inputs, the port on the CPU (`device="cpu"`) and the JAX
package on its CPU path. The CUDA versions are tested on the card by
tests/test_torch_cuda.py.

Gates: port vs JAX >= 110 dB SNR for outputs linear in the signal
(convolutions, filters, STFT, istft where the summed window energy is
>= 1e-3: elsewhere both divide rounding noise by about 1e-10), >= 100 dB
for products of two spectra (PSDs, correlations, the spectrogram's
magnitudes), coherence within 1e-4, `spectral_stats` within 1e-6
relative. jax x64 is on (tests/conftest.py), so every input is cast to
float32 (complex64) explicitly on both sides; the spectrogram's average
is also held against a float64 sequential average. Sizes stay at most
4096 samples."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.dsp.convolution as jx_conv
import fftlab.dsp.filtering as jx_filt
import fftlab.dsp.spectrum as jx_spec
from _torch_parity import snr_db, tt
from fftlab.algos import build_registry as jx_registry
from fftlab.dsp.stft import istft as jx_istft
from fftlab.dsp.stft import spectrogram as jx_spectrogram
from fftlab.dsp.stft import stft as jx_stft
from fftlab.dsp.stft import stft_complex as jx_stft_complex
from fftlab_torch.algos import build_registry as pt_registry
from fftlab_torch.core.types import to_host
from fftlab_torch.core.window import get_window
from fftlab_torch.dsp import convolution, filtering, spectrum
from fftlab_torch.dsp.stft import ema_frames, istft, spectrogram, stft, stft_complex


@pytest.fixture(autouse=True)
def _no_forced_route(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)


def sig(seed: int, shape, complex_: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal(shape).astype(np.float32)).astype(np.complex64)
    return x


def both(pt_fn, jx_fn, *args, **kw):
    """(port result on the CPU as numpy, JAX result as numpy) of the same
    numpy arguments."""
    got = pt_fn(*args, device="cpu", **kw)
    want = jx_fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    return to_host(got), np.asarray(want)


def gate(got, want, limit):
    assert got.shape == want.shape
    assert snr_db(got, want) >= limit


# ------------------------------------------------------------ convolution

CONV = {
    "direct_real": (convolution.direct_convolution, jx_conv.direct_convolution,
                    ((4, 1000), False), ((33,), False), {}),
    "direct_complex": (convolution.direct_convolution, jx_conv.direct_convolution,
                       ((2, 500), True), ((17,), True), {}),
    "direct_mixed": (convolution.direct_convolution, jx_conv.direct_convolution,
                     ((3, 300), True), ((9,), False), {}),
    "fft_real": (convolution.fft_convolution, jx_conv.fft_convolution,
                 ((4, 1000), False), ((33,), False), {}),
    "fft_complex": (convolution.fft_convolution, jx_conv.fft_convolution,
                    ((2, 777), True), ((65,), True), {}),
    "circular_real": (convolution.circular_convolution, jx_conv.circular_convolution,
                      ((3, 256), False), ((256,), False), {}),
    "circular_complex": (convolution.circular_convolution, jx_conv.circular_convolution,
                         ((240,), True), ((240,), True), {}),
    "overlap_save_real": (convolution.overlap_save, jx_conv.overlap_save,
                          ((2, 4096), False), ((65,), False), {}),
    "overlap_save_block": (convolution.overlap_save, jx_conv.overlap_save,
                           ((3, 1000), False), ((17,), False), {"block": 64}),
    "overlap_save_complex": (convolution.overlap_save, jx_conv.overlap_save,
                             ((1500,), True), ((33,), True), {}),
    "overlap_add_real": (convolution.overlap_add, jx_conv.overlap_add,
                         ((2, 4096), False), ((65,), False), {}),
    "overlap_add_block": (convolution.overlap_add, jx_conv.overlap_add,
                          ((3, 1000), False), ((17,), False), {"block": 100}),
    "overlap_add_complex": (convolution.overlap_add, jx_conv.overlap_add,
                            ((1500,), True), ((129,), True), {}),
    "convolve2d_real": (convolution.convolve2d, jx_conv.convolve2d,
                        ((40, 48), False), ((5, 7), False), {}),
    "convolve2d_complex": (convolution.convolve2d, jx_conv.convolve2d,
                           ((2, 30, 20), True), ((3, 3), True), {}),
}


@pytest.mark.parametrize("case", list(CONV))
def test_convolution_matches_jax(case):
    pt_fn, jx_fn, (xs, xc), (hs, hc), kw = CONV[case]
    x, h = sig(len(case), xs, xc), sig(len(case) + 1, hs, hc)
    got, want = both(pt_fn, jx_fn, x, h, **kw)
    assert np.iscomplexobj(got) == (xc or hc)
    gate(got, want, 110.0)


def test_direct_convolution_is_np_convolve():
    """No conjugation and no flip lost: the direct convolution of complex
    signals is np.convolve's, row by row."""
    x, h = sig(1, (3, 200), True), sig(2, (13,), True)
    got = to_host(convolution.direct_convolution(x, h, device="cpu"))
    want = np.stack([np.convolve(r.astype(np.complex128), h.astype(np.complex128))
                     for r in x])
    assert snr_db(got, want) >= 120.0


@pytest.mark.parametrize("name", ["naive_dft", "radix4", "four_step"])
def test_convolution_takes_a_registry_cfft(name):
    x, h = sig(3, (2, 200), False), sig(4, (57,), False)  # m = 256
    got = to_host(convolution.fft_convolution(x, h, cfft=pt_registry()[name].fn,
                                              device="cpu"))
    want = np.asarray(jx_conv.fft_convolution(jnp.asarray(x), jnp.asarray(h),
                                              cfft=jx_registry()[name].fn))
    gate(got, want, 110.0)


def test_convolution_keeps_a_tensor_on_its_device():
    x, h = tt(sig(5, (300,))), sig(6, (11,))
    y = convolution.fft_convolution(x, h)  # no device: the tensor's own
    assert y.device.type == "cpu" and y.dtype == torch.float32


# -------------------------------------------------------------- filtering

FT = jx_filt.FilterType
FILTERS = {
    "lowpass": (filtering.FilterType.LOWPASS, FT.LOWPASS, (300.0, 0.0), 0.0),
    "highpass": (filtering.FilterType.HIGHPASS, FT.HIGHPASS, (2000.0, 0.0), 100.0),
    "bandpass": (filtering.FilterType.BANDPASS, FT.BANDPASS, (800.0, 2000.0), 100.0),
    "bandstop": (filtering.FilterType.BANDSTOP, FT.BANDSTOP, (500.0, 1500.0), 0.0),
}


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("kind", list(FILTERS))
def test_fft_filter_matches_jax(kind, complex_):
    pt_type, jx_type, (lo, hi), tw = FILTERS[kind]
    pt_p = filtering.FilterParams(pt_type, lo, hi, 8000.0, tw)
    jx_p = jx_filt.FilterParams(jx_type, lo, hi, 8000.0, tw)
    x = sig(7, (3, 1024), complex_)
    got = to_host(filtering.fft_filter(x, pt_p, device="cpu"))
    want = np.asarray(jx_filt.fft_filter(jnp.asarray(x), jx_p))
    assert np.iscomplexobj(got) == complex_
    gate(got, want, 110.0)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_fft_filter_custom_matches_jax(complex_):
    x = sig(8, (2, 1000), complex_)
    H = sig(9, (1000,), True)
    got = to_host(filtering.fft_filter_custom(x, H, device="cpu"))
    want = np.asarray(jx_filt.fft_filter_custom(jnp.asarray(x), H))
    gate(got, want, 110.0)


@pytest.mark.parametrize("taps", [64, 101])
def test_design_fir_takes_cfft_and_matches_jax(taps):
    pt_p = filtering.FilterParams(filtering.FilterType.LOWPASS, 1000.0, 0.0, 8000.0, 200.0)
    jx_p = jx_filt.FilterParams(FT.LOWPASS, 1000.0, 0.0, 8000.0, 200.0)
    got = filtering.design_fir(taps, pt_p, cfft=pt_registry()["stockham_mxu"].fn)
    np.testing.assert_allclose(got, jx_filt.design_fir(taps, jx_p), rtol=0, atol=1e-12)


# --------------------------------------------------------------- spectrum

@pytest.mark.parametrize("window", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("shape", [(1024,), (3, 1000)], ids=["1024", "3x1000"])
def test_periodogram_matches_jax(shape, window):
    x = sig(10, shape)
    f_pt, p_pt = spectrum.periodogram(x, 500.0, window, device="cpu")
    f_jx, p_jx = jx_spec.periodogram(jnp.asarray(x), 500.0, window)
    np.testing.assert_array_equal(f_pt, f_jx)
    gate(to_host(p_pt), np.asarray(p_jx), 100.0)


@pytest.mark.parametrize("window_size,overlap", [(256, 0.5), (512, 0.75), (200, 0.0)])
def test_welch_psd_matches_jax(window_size, overlap):
    x = sig(11, (4096,))
    f_pt, p_pt = spectrum.welch_psd(x, 1000.0, window_size, overlap, device="cpu")
    f_jx, p_jx = jx_spec.welch_psd(jnp.asarray(x), 1000.0, window_size, overlap)
    np.testing.assert_array_equal(f_pt, f_jx)
    gate(to_host(p_pt), np.asarray(p_jx), 100.0)


@pytest.mark.parametrize("shape", [(1000,), (3, 777)], ids=["1000", "3x777"])
def test_autocorrelation_matches_jax(shape):
    x = sig(12, shape)
    got, want = both(spectrum.autocorrelation, jx_spec.autocorrelation, x)
    gate(got, want, 100.0)


@pytest.mark.parametrize("shape", [(700,), (2, 1000)], ids=["700", "2x1000"])
def test_cross_correlation_matches_jax(shape):
    x, y = sig(13, shape), sig(14, shape)
    got, want = both(spectrum.cross_correlation, jx_spec.cross_correlation, x, y)
    gate(got, want, 100.0)
    r = np.correlate(y[..., :].reshape(-1, shape[-1])[0].astype(np.float64),
                     x.reshape(-1, shape[-1])[0].astype(np.float64), "full")
    assert snr_db(got.reshape(-1, 2 * shape[-1] - 1)[0], r) >= 100.0


# m = next_pow2(2n): 2048 (the einsum route) and 8192 (`smem_rows`, the
# plain version of `fft_rows` on the CPU)
@pytest.mark.parametrize("shape", [(1000,), (2, 4096)], ids=["einsum", "smem_rows"])
def test_split_correlations_match_jax(shape):
    x, y = sig(15, shape), sig(16, shape)
    got, want = both(spectrum.autocorrelation_split, jx_spec.autocorrelation_split, x)
    gate(got, want, 100.0)
    gate(got, np.asarray(jx_spec.autocorrelation(jnp.asarray(x))), 100.0)
    got, want = both(spectrum.cross_correlation_split, jx_spec.cross_correlation_split, x, y)
    gate(got, want, 100.0)
    gate(got, np.asarray(jx_spec.cross_correlation(jnp.asarray(x), jnp.asarray(y))), 100.0)


@pytest.mark.parametrize("window_size", [128, 256])
def test_coherence_matches_jax(window_size):
    x = sig(17, (4096,))
    y = (0.7 * np.roll(x, 3) + 0.3 * sig(18, (4096,))).astype(np.float32)
    f_pt, c_pt = spectrum.coherence(x, y, 100.0, window_size, device="cpu")
    f_jx, c_jx = jx_spec.coherence(jnp.asarray(x), jnp.asarray(y), 100.0, window_size)
    np.testing.assert_array_equal(f_pt, f_jx)
    np.testing.assert_allclose(to_host(c_pt), np.asarray(c_jx), rtol=0, atol=1e-4)


def test_coherence_needs_two_segments():
    with pytest.raises(ValueError, match=">= 2 Welch segments"):
        spectrum.coherence(sig(0, (256,)), sig(1, (256,)), window_size=256, device="cpu")


@pytest.mark.parametrize("source", ["tensor", "numpy"])
def test_spectral_stats_matches_jax(source):
    x = sig(19, (4096,))
    freqs, psd = spectrum.welch_psd(x, 1000.0, device="cpu")
    psd_in = psd if source == "tensor" else to_host(psd)
    got = spectrum.spectral_stats(psd_in, freqs)
    want = jx_spec.spectral_stats(to_host(psd), freqs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0.0)


# ------------------------------------------------------------------- STFT

STFT_CASES = [((4096,), 256, 64), ((4096,), 512, 128), ((2, 3000), 200, 50),
              ((1500,), 128, 128)]
STFT_IDS = ["4096-256/64", "4096-512/128", "2x3000-200/50", "1500-128/128"]


@pytest.mark.parametrize("shape,fft_size,hop", STFT_CASES, ids=STFT_IDS)
def test_stft_matches_jax(shape, fft_size, hop):
    x = sig(20, shape)
    got, want = both(stft, jx_stft, x, fft_size, hop)
    gate(got, want, 110.0)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("shape,fft_size,hop", STFT_CASES[:3], ids=STFT_IDS[:3])
def test_stft_complex_matches_jax(shape, fft_size, hop, complex_):
    x = sig(21, shape, complex_)
    got, want = both(stft_complex, jx_stft_complex, x, fft_size, hop)
    gate(got, want, 110.0)


@pytest.mark.parametrize("shape,fft_size,hop", STFT_CASES[:3], ids=STFT_IDS[:3])
def test_istft_matches_jax(shape, fft_size, hop):
    x = sig(22, shape)
    S = np.asarray(jx_stft(jnp.asarray(x), fft_size, hop)).astype(np.complex64)
    got = to_host(istft(S, fft_size, hop, length=shape[-1], device="cpu"))
    want = np.asarray(jx_istft(jnp.asarray(S), fft_size, hop, length=shape[-1]))
    # where the summed window energy is at least 1e-3
    w2 = np.asarray(get_window("hann", fft_size)) ** 2
    n_frames = S.shape[-2]
    energy = np.zeros((n_frames - 1) * hop + fft_size)
    for f in range(n_frames):
        energy[f * hop: f * hop + fft_size] += w2
    keep = energy[: shape[-1]] >= 1e-3
    gate(got[..., keep], want[..., keep], 110.0)
    gate(got[..., keep], x[..., keep], 110.0)


@pytest.mark.parametrize("averaging", [1, 4])
@pytest.mark.parametrize("shape,fft_size,hop", STFT_CASES[:3], ids=STFT_IDS[:3])
def test_spectrogram_matches_jax(shape, fft_size, hop, averaging):
    x = sig(23, shape)
    got, want = both(spectrogram, jx_spectrogram, x, fft_size, hop,
                     averaging=averaging)
    gate(got, want, 100.0)


@pytest.mark.parametrize("frames", [1, 2, 3, 17, 64, 257])
@pytest.mark.parametrize("averaging", [2, 4, 7])
def test_ema_frames_is_the_sequential_average(frames, averaging):
    """The doubling scan against the float64 sequential recurrence
    c_t = (1-a) c_{t-1} + a m_t, c_{-1} = m_0."""
    m = np.abs(sig(frames + averaging, (2, frames, 33))).astype(np.float32)
    got = to_host(ema_frames(torch.from_numpy(m.copy()), averaging))
    a = 1.0 / averaging
    c = m[..., 0, :].astype(np.float64)
    want = np.empty(m.shape)
    for t in range(frames):
        c = (1 - a) * c + a * m[..., t, :]
        want[..., t, :] = c
    assert snr_db(got, want) >= 120.0


# -------------------------------------------------- the device of the input

NUMPY_CALLS = {
    "direct_convolution": lambda x: convolution.direct_convolution(x, x[:5]),
    "fft_convolution": lambda x: convolution.fft_convolution(x, x[:5]),
    "circular_convolution": lambda x: convolution.circular_convolution(x, x),
    "overlap_save": lambda x: convolution.overlap_save(x, x[:5]),
    "overlap_add": lambda x: convolution.overlap_add(x, x[:5]),
    "convolve2d": lambda x: convolution.convolve2d(x.reshape(16, 16), x[:4].reshape(2, 2)),
    "fft_filter": lambda x: filtering.fft_filter(
        x, filtering.FilterParams(filtering.FilterType.LOWPASS, 0.1)),
    "fft_filter_custom": lambda x: filtering.fft_filter_custom(x, np.ones(256)),
    "periodogram": lambda x: spectrum.periodogram(x),
    "welch_psd": lambda x: spectrum.welch_psd(x, window_size=64),
    "autocorrelation": lambda x: spectrum.autocorrelation(x),
    "cross_correlation": lambda x: spectrum.cross_correlation(x, x),
    "coherence": lambda x: spectrum.coherence(x, x, window_size=64),
    "autocorrelation_split": lambda x: spectrum.autocorrelation_split(x),
    "cross_correlation_split": lambda x: spectrum.cross_correlation_split(x, x),
    "stft": lambda x: stft(x, 64, 16),
    "stft_complex": lambda x: stft_complex(x, 64, 16),
    "istft": lambda x: istft(np.ones((3, 33), np.complex64), 64, 16),
    "spectrogram": lambda x: spectrogram(x, 64, 16, averaging=4),
}


@pytest.mark.parametrize("name", list(NUMPY_CALLS))
def test_numpy_input_needs_the_card(monkeypatch, name):
    """Input that is not a tensor goes to the card by default; with no
    CUDA device that raises and names `device="cpu"`, never falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NUMPY_CALLS[name](sig(24, (256,)))
