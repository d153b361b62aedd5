"""fftlab_torch's STFT path: the K12 counterpart (`pallas_stft_split`,
the plain version of `stft_frames`), `stft_split`/`istft_split`, the
framing and overlap-add, and Welch's PSD and coherence, each against
the JAX package on the same float32 inputs: the JAX kernel in interpret
mode at the JAX suite's sizes (tests/test_stft_kernel.py:19-40), JAX's
CPU path for the rest. The CUDA kernel is tested on the card by
tests/test_torch_cuda.py.

Gates: >= 110 dB SNR against a float64 framed rfft and >= 110 dB port
vs JAX (float32 on both sides, different summation orders). The inverse
STFT divides by the summed window energy, which is about 1e-10 at the
signal's ends; there both packages divide rounding noise by nearly zero,
so the inverse is compared where that energy is at least 1e-3."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.core.framing as jx_framing
import fftlab.dsp.spectrum as jx_spectrum
import fftlab.kernels.stft_vmem as jx_kernel
from _torch_parity import cplx, snr_db, tt
from fftlab.dsp.stft import _cola_overlap_add as jx_cola_overlap_add
from fftlab.dsp.stft import frame_signal as jx_frame_signal
from fftlab.dsp.stft import istft_split as jx_istft_split
from fftlab.dsp.stft import stft_split as jx_stft_split
import fftlab_torch
from fftlab_torch.core.window import get_window
from fftlab_torch.kernels import stft_vmem

# the module: `fftlab_torch.dsp.stft` is the function, as `fftlab.dsp.stft` is
pt_stft = importlib.import_module("fftlab_torch.dsp.stft")


def real(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def stft_oracle(x: np.ndarray, fft_size: int, hop: int, n_frames: int,
                window="hann", onesided: bool = True) -> np.ndarray:
    """float64 framed rfft over the zero-extended signal."""
    need = (n_frames - 1) * hop + fft_size
    xp = np.zeros(max(need, len(x)))
    xp[:len(x)] = x
    w = get_window(window, fft_size)
    frames = np.stack([xp[k * hop:k * hop + fft_size] * w for k in range(n_frames)])
    return np.fft.rfft(frames) if onesided else np.fft.fft(frames)


# --------------------------------------------------------- K12 counterpart

KERNEL_CASES = [(2048, 512, 16384), (256, 128, 20000), (128, 128, 5000),
                (512, 256, 7001), (1024, 128, 9999)]


@pytest.mark.parametrize("fft_size,hop,n", KERNEL_CASES)
@pytest.mark.parametrize("onesided", [True, False], ids=["onesided", "twosided"])
def test_pallas_stft_matches_pallas(fft_size, hop, n, onesided):
    x = real(fft_size + hop + n, n)
    got = cplx(*stft_vmem.pallas_stft_split(tt(x), fft_size, hop, onesided=onesided))
    want = cplx(*jx_kernel.pallas_stft_split(x, fft_size, hop, onesided=onesided,
                                             interpret=True))
    assert got.shape == want.shape
    assert snr_db(got, want) >= 110.0
    # the JAX kernel pads the tail to a multiple of 128 and counts frames
    # on the padded length
    n_frames = (-(-n // 128) * 128 - fft_size) // hop + 1
    assert got.shape[0] == n_frames
    assert snr_db(got, stft_oracle(x, fft_size, hop, n_frames, onesided=onesided)) >= 110.0


def _stft_kernel_model(x, fft_size, hop, w, n_frames, onesided, T, x_shift, y_shift):
    """csrc/real.cu `stft_frames_kernel` as numpy index maths over the
    kernel's shared memory (`stft_vmem.stft_layout`): per block of T
    frames, the 16-byte words of the span at `span_at`, the frames' pairs
    read back through the span offsets, the FFT (float64 numpy here) left
    in the engine's planes, the paired unpack into the staging planes
    (rows of `bins`, the mirrors, the output's alignment shift) and the
    block's rows copied out as one run. x sits `x_shift` floats past a
    16-byte boundary and each output plane `y_shift` floats past one.
    Shared memory starts as NaN and the floats before x[0] are NaN, so a
    read of anything the kernel did not write shows in the result."""
    m = fft_size // 2
    half = m // 2
    bins = m + 1 if onesided else fft_size
    geo = stft_vmem.stft_geometry(fft_size, hop, T, bins)
    lay = stft_vmem.stft_layout(m, hop, T, geo.stride, bins)
    assert geo.smem == 4 * lay.total and lay.span == 2 * T * geo.stride
    n = len(x)
    mem = np.concatenate([np.full(x_shift, np.nan), x.astype(np.float64), np.zeros(8)])
    out = np.full((2, n_frames * bins), np.nan)

    def plane_at(t, e):
        if geo.log_pad == 0:
            return e ^ ((e >> 4) & 31)
        return t * geo.stride + e + (e >> geo.log_pad)

    def unpack(zl, zh, w):
        """csrc/real.cu `unpack_pair`: (X[k], X[m-k]) from Z[k], Z[m-k]."""
        er, ei = 0.5 * (zl.real + zh.real), 0.5 * (zl.imag - zh.imag)
        wo = (0.5 * (zl.imag + zh.imag) - 0.5j * (zl.real - zh.real)) * w
        return er + wo.real + 1j * (ei + wo.imag), er - wo.real + 1j * (wo.imag - ei)

    k = np.arange(half)
    utw = np.exp(-2j * np.pi * np.arange(half + 1) / fft_size)
    for f0 in range(0, n_frames, T):
        smem = np.full(lay.total, np.nan)
        for s in range(lay.nseg):
            g0 = (f0 + s) * hop
            g = g0 - (x_shift + g0) % 4 + 4 * np.arange(lay.words)
            assert np.all((x_shift + g) % 4 == 0) and g[0] >= -x_shift
            dst = lay.span + s * lay.seg_pitch + stft_vmem.span_at(4 * np.arange(lay.words))
            assert dst[-1] + 4 <= lay.span + (s + 1) * lay.seg_pitch
            for i in range(4):  # floats from x[n] on read as zeros
                smem[dst + i] = np.where(g + i < n, mem[np.minimum(x_shift + g + i, n + x_shift)], 0.0)
        assert lay.window + fft_size <= lay.total
        smem[lay.window:lay.window + fft_size] = w
        Z = []
        for t in range(T):
            s = 0 if lay.nseg == 1 else t
            lead = (x_shift + (f0 + s) * hop) % 4
            u = lead + (t * hop if lay.nseg == 1 else 0) + 2 * np.arange(m)
            a = lay.span + s * lay.seg_pitch + stft_vmem.span_at(u)
            wa = lay.window + 2 * np.arange(m)
            Z.append(np.fft.fft(smem[a] * smem[wa] + 1j * smem[a + 1] * smem[wa + 1]))
        at = np.array([[plane_at(t, e) for e in range(m)] for t in range(T)])
        assert len(np.unique(at)) == T * m and at.max() < geo.stride * T <= lay.span // 2
        planes = np.full(lay.span // 2, np.nan, complex)
        planes[at] = np.array(Z)
        sh = [(y_shift + f0 * bins) % 4] * 2
        base = [sh[0], lay.stage_pitch + sh[1]]
        for t in range(T):
            low, high = unpack(planes[at[t, k]], planes[at[t, np.where(k == 0, 0, m - k)]],
                               utw[:half])
            zm = planes[at[t, [half]]]
            mid = unpack(zm, zm, utw[half])[0]
            for bin_, v in ((k, low), (m - k, high), (np.array([half]), mid)):
                for p, part in enumerate((v.real, v.imag)):
                    assert base[p] + t * bins + bins <= (p + 1) * lay.stage_pitch
                    smem[base[p] + t * bins + bin_] = part
                    if not onesided:
                        mir = (bin_ >= 1) & (bin_ < m)
                        smem[base[p] + t * bins + 2 * m - bin_[mir]] = (-1) ** p * part[mir]
        rows = min(T, n_frames - f0) * bins
        for p in range(2):
            out[p, f0 * bins:f0 * bins + rows] = smem[base[p]:base[p] + rows]
    assert np.isfinite(out).all()
    return out[0].reshape(n_frames, bins) + 1j * out[1].reshape(n_frames, bins)


@pytest.mark.parametrize("fft_size,hop,n", KERNEL_CASES)
@pytest.mark.parametrize("onesided", [True, False], ids=["onesided", "twosided"])
def test_stft_kernel_layout_model(fft_size, hop, n, onesided):
    """The staged layout of the `stft_frames` kernel (span offsets, the
    T*bins output region, the mirrors, the alignment shifts) as a numpy
    model, against the plain version and the JAX kernel in interpret mode,
    at T = frames_per_block and at the other T of chip_smoke's A/B."""
    x = real(fft_size + hop + n, n)
    n_frames = (-(-n // 128) * 128 - fft_size) // hop + 1
    w = get_window("hann", fft_size)
    plain = cplx(*stft_vmem.stft_frames_plain(tt(x), fft_size, hop,
                                              tt(w.astype(np.float32)), n_frames, onesided))
    want = cplx(*jx_kernel.pallas_stft_split(x, fft_size, hop, onesided=onesided,
                                             interpret=True))
    T0 = stft_vmem.frames_per_block(fft_size)
    T1 = 2 * T0 if 2 * T0 * fft_size <= 2 * stft_vmem.MAX_TILE else T0 // 2
    for T, x_shift, y_shift in ((T0, 0, 0), (T0, 2, 1), (T1, 2, 3)):
        got = _stft_kernel_model(x, fft_size, hop, w.astype(np.float32), n_frames, onesided,
                                 T, x_shift, y_shift)
        assert got.shape == plain.shape == want.shape
        assert snr_db(got, plain) >= 110.0
        assert snr_db(got, want) >= 110.0


@pytest.mark.parametrize("window", ["hamming", "blackman", np.linspace(0.1, 1.0, 256)],
                         ids=["hamming", "blackman", "array"])
def test_pallas_stft_windows(window):
    x = real(3, 4096)
    got = cplx(*stft_vmem.pallas_stft_split(tt(x), 256, 128, window))
    want = cplx(*jx_kernel.pallas_stft_split(x, 256, 128, window, interpret=True))
    assert snr_db(got, want) >= 110.0


def test_frames_per_block():
    """T frames fill a tile of 2048 complex points, at most the JAX small
    kernel's FBS = 32 frames, at least one."""
    assert stft_vmem.FBS == jx_kernel.FBS == 32
    assert [stft_vmem.frames_per_block(f) for f in (128, 256, 512, 2048, 4096, 16384)] == \
        [32, 16, 8, 2, 1, 1]


@pytest.mark.parametrize("fft_size,hop", [(256, 128), (512, 256), (256, 96), (384, 128),
                                          (1024, 128), (128, 256), (256, 0)])
def test_small_frame_window_matches_jax(fft_size, hop):
    assert (stft_vmem.small_frame_supported(fft_size, hop)
            == jx_kernel.small_frame_supported(fft_size, hop))


@pytest.mark.parametrize("args,match", [
    ((np.zeros(4096, np.float32), 384, 128), "fft_size must be"),
    ((np.zeros(4096, np.float32), 2048, 100), "hop must be"),
    ((np.zeros(1000, np.float32), 2048, 512), "shorter than fft_size"),
    ((np.zeros((2, 4096), np.float32), 2048, 512), "1D signal"),
])
def test_pallas_stft_refusals_match_jax(args, match):
    x, fft_size, hop = args
    with pytest.raises(ValueError, match=match):
        stft_vmem.pallas_stft_split(tt(x), fft_size, hop)
    with pytest.raises(ValueError, match=match):
        jx_kernel.pallas_stft_split(x, fft_size, hop, interpret=True)


def test_stft_refuses_other_dtypes():
    x = torch.zeros(4096, dtype=torch.float64)
    for fn in (stft_vmem.pallas_stft_split, fftlab_torch.stft_split):
        with pytest.raises(ValueError, match="float32"):
            fn(x, 2048, 512)
    with pytest.raises(ValueError, match="float32"):
        fftlab_torch.istft_split(torch.zeros(4, 1025, dtype=torch.float64),
                                 torch.zeros(4, 1025, dtype=torch.float64))


# ------------------------------------------------- stft_split / istft_split

# (fft_size, hop, n): kernel sizes with tails that are not a whole hop
# or a multiple of 128, and sizes the kernel window does not take
SPLIT_CASES = [(2048, 512, 16384), (2048, 512, 16000), (256, 128, 20001),
               (1024, 256, 1000), (1000, 250, 9000), (256, 96, 5000), (512, 200, 4097)]


@pytest.mark.parametrize("fft_size,hop,n", SPLIT_CASES)
def test_stft_split_matches_jax(fft_size, hop, n):
    x = real(n + hop, n)
    got = cplx(*fftlab_torch.stft_split(tt(x), fft_size, hop))
    want = cplx(*jx_stft_split(x, fft_size, hop))
    n_frames = max(-(-max(n - fft_size, 0) // hop) + 1, 1)
    assert got.shape == want.shape == (n_frames, fft_size // 2 + 1)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, stft_oracle(x, fft_size, hop, n_frames)) >= 110.0


@pytest.mark.parametrize("fft_size,hop", [(2048, 512), (1000, 250)])
def test_stft_split_twosided(fft_size, hop):
    x = real(fft_size, 9000)
    got = cplx(*fftlab_torch.stft_split(tt(x), fft_size, hop, onesided=False))
    want = cplx(*jx_stft_split(x, fft_size, hop, onesided=False))
    assert got.shape == want.shape
    assert snr_db(got, want) >= 110.0


@pytest.mark.parametrize("fft_size,hop,n", [(2048, 512, 16384), (2048, 512, 16000),
                                            (256, 128, 20001), (512, 200, 4097)])
def test_istft_split_matches_jax(fft_size, hop, n):
    x = real(n + 7, n)
    Sr, Si = jx_stft_split(x, fft_size, hop)
    got = fftlab_torch.istft_split(tt(np.array(Sr)), tt(np.array(Si)), fft_size, hop,
                                   length=n).numpy()
    want = np.asarray(jx_istft_split(Sr, Si, fft_size, hop, length=n))
    assert got.shape == want.shape == (n,)
    n_frames = int(Sr.shape[0])
    w2 = get_window("hann", fft_size) ** 2
    norm = np.zeros((n_frames - 1) * hop + fft_size)
    for f in range(n_frames):
        norm[f * hop:f * hop + fft_size] += w2
    keep = norm[:n] >= 1e-3
    assert snr_db(got[keep], want[keep]) >= 110.0
    assert snr_db(got[keep], x[keep].astype(np.float64)) >= 110.0


def test_stft_round_trip_through_the_port():
    x = real(11, 30000)
    S = fftlab_torch.stft_split(tt(x), 2048, 512)
    y = fftlab_torch.istft_split(*S, 2048, 512, length=len(x)).numpy()
    assert snr_db(y[2048:-2048], x[2048:-2048].astype(np.float64)) >= 110.0


def test_istft_refusals():
    z = torch.zeros(4, 1025)
    with pytest.raises(ValueError, match="n_frames, bins"):
        fftlab_torch.istft_split(z[0], z[0])
    with pytest.raises(ValueError, match="even fft_size"):
        fftlab_torch.istft_split(z, z, fft_size=2047)
    with pytest.raises(ValueError, match="one-sided bins"):
        fftlab_torch.istft_split(z, z, fft_size=1024)


@pytest.mark.parametrize("frame,hop,n", [(256, 128, 1000), (256, 100, 1001),
                                         (512, 512, 300)])
@pytest.mark.parametrize("pad", [True, False])
def test_frame_signal_matches_jax(frame, hop, n, pad):
    x = real(n, n)
    if not pad and n < frame:
        return
    got = pt_stft.frame_signal(tt(x), frame, hop, pad).numpy()
    want = np.asarray(jx_frame_signal(x, frame, hop, pad))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fft_size,hop,frames", [(256, 64, 9), (256, 100, 7), (100, 100, 4),
                                                 (2048, 512, 3)])
def test_cola_overlap_add_matches_jax(fft_size, hop, frames):
    f = np.random.default_rng(fft_size + hop).standard_normal((frames, fft_size)).astype(
        np.float32)
    w = get_window("hann", fft_size)
    """Where hop divides fft_size both packages add the same chunks in the
    same order: equal bit for bit. Otherwise the JAX package adds frame by
    frame and the port chunk by chunk, so a sample's two or three terms
    are summed in another order: >= 110 dB where the window energy it is
    divided by is at least 1e-3."""
    got = pt_stft._cola_overlap_add(tt(f), w, fft_size, hop).numpy()
    want = np.asarray(jx_cola_overlap_add(jnp.asarray(f), w, fft_size, hop))
    assert got.shape == want.shape == ((frames - 1) * hop + fft_size,)
    if fft_size % hop == 0:
        assert np.array_equal(got, want)
    else:
        norm = np.zeros_like(got, dtype=np.float64)
        for k in range(frames):
            norm[k * hop:k * hop + fft_size] += w * w
        keep = norm >= 1e-3
        assert snr_db(got[keep], want[keep]) >= 110.0


def test_stft_kernel_routing_matches_jax():
    """The same (fft_size, hop) take the kernel in both packages
    (stft.py:185-187)."""
    for fft_size, hop in [(2048, 512), (1024, 100), (256, 128), (256, 96), (1000, 250),
                          (16384, 4096), (32768, 128), (128, 128)]:
        jax_kernel = ((jx_kernel.supported_size(fft_size) and hop % 128 == 0)
                      or jx_kernel.small_frame_supported(fft_size, hop))
        assert stft_vmem.kernel_supported(fft_size, hop) == jax_kernel


# ---------------------------------------------------- Welch and coherence


@pytest.mark.parametrize("window_size,overlap,n", [(256, 0.5, 30000), (512, 0.75, 20001),
                                                   (1000, 0.5, 12345)])
def test_welch_psd_matches_jax(window_size, overlap, n):
    x = real(n, n)
    f, p = fftlab_torch.welch_psd_split(tt(x), 1000.0, window_size, overlap)
    fj, pj = jx_spectrum.welch_psd_split(x, 1000.0, window_size, overlap)
    assert np.array_equal(f, fj)
    assert p.shape == (window_size // 2 + 1,)
    assert snr_db(p.numpy(), np.asarray(pj, np.float64)) >= 110.0
    # float64 Welch: the mean of the whole segments' periodograms
    hop = int(window_size * (1 - overlap))
    n_seg = (n - window_size) // hop + 1
    X = stft_oracle(x, window_size, hop, n_seg)
    w = get_window("hann", window_size)
    want = np.mean(np.abs(X) ** 2, axis=0) / (1000.0 * window_size * np.mean(w * w))
    want[1:-1] *= 2.0
    assert snr_db(p.numpy(), want) >= 110.0


@pytest.mark.parametrize("window_size,overlap", [(256, 0.5), (384, 0.5)])
def test_coherence_matches_jax(window_size, overlap):
    x = real(1, 30000)
    y = 0.7 * x + 0.3 * real(2, 30000)
    f, c = fftlab_torch.coherence_split(tt(x), tt(y), 1.0, window_size, overlap)
    fj, cj = jx_spectrum.coherence_split(x, y, 1.0, window_size, overlap)
    assert np.array_equal(f, fj)
    assert snr_db(c.numpy(), np.asarray(cj, np.float64)) >= 110.0
    assert float(c.min()) >= 0.0 and float(c.max()) <= 1.0 + 1e-5


def test_coherence_needs_two_segments():
    x = torch.zeros(300)
    with pytest.raises(ValueError, match=">= 2 Welch segments"):
        fftlab_torch.coherence_split(x, x)


def test_framing_strategies_agree():
    """The port's one strided view equals every framing strategy of the
    JAX package (core/framing.py)."""
    x = real(5, 3000)
    got = pt_stft.frame_signal(tt(x), 256, 100).numpy()
    want = np.asarray(jx_framing.frame_signal_strided(x, 256, 100, got.shape[0]))
    assert np.array_equal(got, want)
