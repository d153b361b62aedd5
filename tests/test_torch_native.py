"""The port's native runtime (fftlab_torch.native) against the JAX
package's (fftlab.native): the same C++ sources, the port's own loader.

Mirrors tests/test_native.py and tests/test_native_fft64.py, and holds
the two packages' wrappers to each other on the same files and arrays:
WAV files byte for byte and sample for sample, the ring buffer's reads
exactly, the Q15 FFT's int16 planes and block exponent exactly, the
float64 FFT and `plan_dft_1d_native` exactly (the same C++ on the same
float64 input). Gates against numpy's float64 FFT as in the JAX suite:
> 250 dB for fft64, > 25 dB for Q15, 1.5 LSB for a PCM16 round trip.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_native
from fftlab.native import fft64 as jx_fft64
from fftlab.native import q15 as jx_q15
from fftlab.native import ring as jx_ring
from fftlab.native import wav as jx_wav
from fftlab.plan.api import plan_dft_1d_native as jx_plan_native
from fftlab_torch.native import lib
from fftlab_torch.native.fft64 import fft64, fft64_split
from fftlab_torch.native.q15 import (float_to_q15, q15_fft, q15_fft_float, q15_normalize,
                                     q15_to_float)
from fftlab_torch.native.ring import RingBuffer
from fftlab_torch.native.wav import read_wav, wav_info, write_wav
from fftlab_torch.plan.api import plan_dft_1d_native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _jax_library():
    jax_native()


def _snr(got, want):
    return 10 * np.log10(np.sum(np.abs(want) ** 2)
                         / max(np.sum(np.abs(got - want) ** 2), 1e-300))


# -- the loader ---------------------------------------------------------------

def test_builds_into_its_own_directory():
    so = Path(lib.load_native_lib()._name)
    assert so == lib.library_path()
    assert so.parent.parent == lib.BUILD_ROOT
    assert lib.BUILD_ROOT == REPO / "fftlab_torch" / "_build" / "native"
    assert lib.native_available()


def test_digest_follows_the_sources(tmp_path, monkeypatch):
    for name in lib.SOURCES:
        (tmp_path / name).write_bytes((lib.NATIVE_DIR / name).read_bytes())
    monkeypatch.setattr(lib, "NATIVE_DIR", tmp_path)
    same = lib.source_digest()
    (tmp_path / lib.SOURCES[0]).write_text("// changed\n")
    assert lib.source_digest() != same


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    for name in lib.SOURCES:
        (tmp_path / name).write_text("int broken(\n")
    monkeypatch.setattr(lib, "NATIVE_DIR", tmp_path)
    out = tmp_path / "build" / lib.LIB_NAME
    with pytest.raises(RuntimeError, match="(?s)native library unavailable.*error"):
        lib.build_library(out)
    assert not out.exists()
    assert not list(out.parent.glob("*.tmp"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(lib.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        lib.build_library(tmp_path / lib.LIB_NAME)


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory at the same moment:
    both load a whole library, and no temporary file is left."""
    code = ("import sys; from pathlib import Path; import fftlab_torch.native.lib as L; "
            "L.BUILD_ROOT = Path(sys.argv[1]); lib = L.load_native_lib(); "
            "print(lib._name); assert lib.fftlab_ring_create(8)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).is_file()
    assert not list(tmp_path.rglob("*.tmp"))


# -- WAV --------------------------------------------------------------------

class TestWav:
    def test_roundtrip_mono(self, tmp_path):
        fs = 8000
        t = np.arange(4000) / fs
        x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        p = str(tmp_path / "tone.wav")
        write_wav(p, x, fs)
        assert wav_info(p) == {"sample_rate": fs, "channels": 1, "frames": 4000, "bits": 16}
        y, fs2 = read_wav(p)
        assert fs2 == fs
        np.testing.assert_allclose(y, x, atol=1.0 / 32000)

    def test_roundtrip_stereo(self, tmp_path):
        rng = np.random.default_rng(0)
        x = (0.8 * rng.standard_normal((1000, 2))).clip(-1, 1).astype(np.float32)
        p = str(tmp_path / "st.wav")
        write_wav(p, x, 44100)
        y, fs = read_wav(p)
        assert y.shape == (1000, 2) and fs == 44100
        # the writer scales by 32767, the reader divides by 32768
        np.testing.assert_allclose(y, x, atol=1.5 / 32768)

    def test_clipping_saturates(self, tmp_path):
        p = str(tmp_path / "clip.wav")
        write_wav(p, np.array([2.0, -2.0], dtype=np.float32), 8000)
        y, _ = read_wav(p)
        assert abs(y[0] - 1.0) < 2e-3 and abs(y[1] + 1.0) < 2e-3

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(OSError):
            wav_info(str(tmp_path / "nope.wav"))

    def test_garbage_file_raises(self, tmp_path):
        p = tmp_path / "bad.wav"
        p.write_bytes(b"not a wav file at all")
        with pytest.raises(OSError):
            read_wav(str(p))

    def test_bad_shape_raises(self, tmp_path):
        with pytest.raises(ValueError):
            write_wav(str(tmp_path / "x.wav"), np.zeros((2, 2, 2), np.float32), 8000)

    @pytest.mark.parametrize("shape", [(3001,), (1000, 2)], ids=["mono", "stereo"])
    def test_files_equal_jax(self, tmp_path, shape):
        """A file the port writes is byte for byte JAX's for the same array,
        and a file JAX writes reads equal in the port."""
        rng = np.random.default_rng(len(shape))
        x = (0.9 * rng.standard_normal(shape)).clip(-1.2, 1.2).astype(np.float32)
        mine, theirs = tmp_path / "mine.wav", tmp_path / "theirs.wav"
        write_wav(str(mine), x, 22050)
        jx_wav.write_wav(str(theirs), x, 22050)
        assert mine.read_bytes() == theirs.read_bytes()
        got, fs = read_wav(str(theirs))
        want, jfs = jx_wav.read_wav(str(theirs))
        assert fs == jfs and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert wav_info(str(theirs)) == jx_wav.wav_info(str(theirs))

    def test_tensor_input(self, tmp_path):
        x = torch.linspace(-0.5, 0.5, 500)
        mine, theirs = tmp_path / "t.wav", tmp_path / "n.wav"
        write_wav(str(mine), x, 8000)
        jx_wav.write_wav(str(theirs), x.numpy(), 8000)
        assert mine.read_bytes() == theirs.read_bytes()


# -- the ring buffer ----------------------------------------------------------

class TestRingBuffer:
    def test_capacity_rounds_to_pow2(self):
        assert RingBuffer(1000).capacity == 1024

    def test_write_read_fifo(self):
        rb = RingBuffer(64)
        assert rb.write(np.arange(10, dtype=np.float32)) == 10
        assert rb.available == 10
        np.testing.assert_array_equal(rb.read(10), np.arange(10, dtype=np.float32))
        assert rb.available == 0

    def test_wraparound(self):
        rb = RingBuffer(16)
        for start in range(0, 100, 10):
            rb.write(np.arange(start, start + 10, dtype=np.float32))
            np.testing.assert_array_equal(rb.read(10),
                                          np.arange(start, start + 10, dtype=np.float32))

    def test_overfill_truncates(self):
        rb = RingBuffer(16)
        assert rb.write(np.zeros(100, dtype=np.float32)) == 16 and rb.space == 0

    def test_peek_hop_overlap(self):
        rb = RingBuffer(2048)
        rb.write(np.arange(600, dtype=np.float32))
        f1 = rb.peek_hop(512, 128)
        assert f1 is not None and f1[0] == 0
        assert rb.peek_hop(512, 128) is None  # 472 left
        rb.write(np.arange(600, 700, dtype=np.float32))
        f2 = rb.peek_hop(512, 128)
        np.testing.assert_array_equal(f1[128:], f2[:384])

    def test_use_after_close_raises(self):
        rb = RingBuffer(256)
        rb.close()
        for op in (lambda: rb.available, lambda: rb.capacity, lambda: rb.space,
                   lambda: rb.write(np.zeros(4, np.float32)), lambda: rb.read(4),
                   lambda: rb.peek_hop(4, 2)):
            with pytest.raises(ValueError, match="closed"):
                op()
        rb.close()  # a second close is fine

    def test_tensor_input(self):
        rb = RingBuffer(64)
        assert rb.write(torch.arange(5, dtype=torch.float32)) == 5
        np.testing.assert_array_equal(rb.read(5), np.arange(5, dtype=np.float32))

    @pytest.mark.parametrize("capacity", [16, 1000])
    def test_same_as_jax(self, capacity):
        """The same operations on both rings give equal results: FIFO reads
        across the wrap, an overfill, and overlapping peek_hop frames."""
        rng = np.random.default_rng(capacity)
        mine, theirs = RingBuffer(capacity), jx_ring.RingBuffer(capacity)
        for step in range(40):
            data = rng.standard_normal(int(rng.integers(0, capacity + 8))).astype(np.float32)
            assert mine.write(data) == theirs.write(data)
            assert (mine.available, mine.space) == (theirs.available, theirs.space)
            if step % 3 == 0:
                a, b = mine.peek_hop(capacity // 2, capacity // 8), \
                    theirs.peek_hop(capacity // 2, capacity // 8)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            k = int(rng.integers(0, capacity + 4))
            np.testing.assert_array_equal(mine.read(k), theirs.read(k))
        assert mine.capacity == theirs.capacity


# -- Q15 --------------------------------------------------------------------

class TestQ15:
    def test_float_q15_roundtrip(self):
        x = np.array([0.0, 0.5, -0.5, 0.999])
        np.testing.assert_allclose(q15_to_float(float_to_q15(x)), x, atol=1.0 / 32768)

    def test_saturation(self):
        assert float_to_q15(np.array([2.0]))[0] == 32767
        assert float_to_q15(np.array([-2.0]))[0] == -32768

    def test_full_scale_no_wrap(self):
        n = 8
        x = np.full(n, 32767, np.int16)
        x[1::2] = -32767
        r, i, sh = q15_fft(x.copy(), x.copy())
        got = (q15_to_float(r) + 1j * q15_to_float(i)) * (1 << sh)
        want = np.fft.fft((x / 32768.0) + 1j * (x / 32768.0))
        np.testing.assert_allclose(got, want, atol=5e-3)

    def test_fft_impulse(self):
        re = np.zeros(64, np.int16)
        re[0] = 16384  # 0.5
        r, i, exp = q15_fft(re, np.zeros(64, np.int16))
        assert exp == 6
        np.testing.assert_allclose(q15_to_float(r), 0.5 / 64, atol=2e-3)
        np.testing.assert_allclose(q15_to_float(i), 0.0, atol=2e-3)

    @pytest.mark.parametrize("n", [64, 256, 1024])
    def test_fft_matches_float_oracle(self, n):
        rng = np.random.default_rng(n)
        z = 0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        assert _snr(q15_fft_float(z), np.fft.fft(z)) > 25.0

    def test_invalid_size_raises(self):
        with pytest.raises(ValueError):
            q15_fft(np.zeros(100, np.int16), np.zeros(100, np.int16))

    def test_normalize(self):
        r, i, shifts = q15_normalize(np.full(8, 100, np.int16), np.zeros(8, np.int16))
        assert shifts == 8 and r[0] == 100 << 8

    def test_inverse_roundtrip(self):
        rng = np.random.default_rng(5)
        z = 0.4 * (rng.standard_normal(256) + 1j * rng.standard_normal(256))
        X = q15_fft_float(z)
        s = np.abs(X).max() / 0.9
        assert _snr(q15_fft_float(X / s, inverse=True) * s, z) > 25.0

    @pytest.mark.parametrize("inverse", [False, True])
    @pytest.mark.parametrize("n", [8, 512])
    def test_same_as_jax(self, n, inverse):
        rng = np.random.default_rng(n)
        re = rng.integers(-30000, 30000, n).astype(np.int16)
        im = rng.integers(-30000, 30000, n).astype(np.int16)
        r, i, e = q15_fft(re, im, inverse)
        jr, ji, je = jx_q15.q15_fft(re, im, inverse)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(i, ji)
        assert e == je
        np.testing.assert_array_equal(q15_fft_float(re / 65536.0, inverse),
                                      jx_q15.q15_fft_float(re / 65536.0, inverse))

    def test_normalize_same_as_jax(self):
        re = np.array([3, -7, 120, 0], np.int16)
        im = np.array([1, 2, -3, 4], np.int16)
        got, want = q15_normalize(re, im), jx_q15.q15_normalize(re, im)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_tensor_input(self):
        re = torch.tensor([16384] + [0] * 15, dtype=torch.int16)
        r, _, exp = q15_fft(re, torch.zeros(16, dtype=torch.int16))
        jr, _, jexp = jx_q15.q15_fft(re.numpy(), np.zeros(16, np.int16))
        np.testing.assert_array_equal(r, jr)
        assert exp == jexp


# -- the float64 FFT and its plan ---------------------------------------------

class TestFFT64:
    @pytest.mark.parametrize("n", [1, 2, 8, 64, 256, 4096])
    def test_matches_numpy_and_jax(self, n):
        rng = np.random.default_rng(n % 13)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = fft64(x)
        assert _snr(got, np.fft.fft(x)) > 250.0
        np.testing.assert_array_equal(got, jx_fft64.fft64(x))

    def test_inverse_roundtrip_and_scaling(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
        np.testing.assert_allclose(fft64(fft64(x), inverse=True), x, atol=1e-12)

    def test_batched_rows_independent(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 2, 128)) + 1j * rng.standard_normal((3, 2, 128))
        got = fft64(x)
        assert got.shape == x.shape
        assert _snr(got, np.fft.fft(x, axis=-1)) > 250.0

    def test_split_planes_and_input_untouched(self):
        rng = np.random.default_rng(9)
        re, im = rng.standard_normal((2, 256)), rng.standard_normal((2, 256))
        re0, im0 = re.copy(), im.copy()
        yr, yi = fft64_split(re, im)
        np.testing.assert_array_equal(re, re0)
        np.testing.assert_array_equal(im, im0)
        jr, ji = jx_fft64.fft64_split(re, im)
        np.testing.assert_array_equal(yr, jr)
        np.testing.assert_array_equal(yi, ji)

    def test_tensor_input(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))
        np.testing.assert_array_equal(fft64(torch.from_numpy(x)), jx_fft64.fft64(x))

    def test_bad_arguments_raise(self):
        with pytest.raises(ValueError):
            fft64(np.zeros(100, complex))
        with pytest.raises(ValueError):
            fft64_split(np.zeros(8), np.zeros(4))
        with pytest.raises(ValueError):
            fft64_split(np.float64(1.0), np.float64(0.0))

    @pytest.mark.parametrize("direction", [-1, 1])
    def test_plan_same_as_jax(self, direction):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((4, 512)) + 1j * rng.standard_normal((4, 512))
        plan, jplan = plan_dft_1d_native(512, direction), jx_plan_native(512, direction)
        assert (plan.kind, plan.algorithm, int(plan.direction)) == \
            (jplan.kind, jplan.algorithm, int(jplan.direction))
        np.testing.assert_array_equal(plan.execute(x), jplan.execute(x))
        with pytest.raises(ValueError):
            plan.execute(x[:, :256])

    def test_plan_refuses_non_pow2(self):
        with pytest.raises(ValueError):
            plan_dft_1d_native(1000)

    def test_plan_raises_at_plan_time_without_a_library(self, monkeypatch):
        def fail():
            raise RuntimeError("native library unavailable: no compiler")

        monkeypatch.setattr(lib, "load_native_lib", fail)
        with pytest.raises(RuntimeError, match="unavailable"):
            plan_dft_1d_native(64)


def test_declared_like_jax():
    """The port's ctypes declarations are the JAX loader's."""
    from fftlab.native import lib as jx_lib

    mine, theirs = lib.load_native_lib(), jx_lib.load_native_lib()
    for name in ("fftlab_wav_info", "fftlab_wav_read_f32", "fftlab_wav_write_pcm16",
                 "fftlab_ring_create", "fftlab_ring_peek_hop", "fftlab_q15_fft",
                 "fftlab_q15_normalize", "fftlab_fft64"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.restype == b.restype and a.argtypes == b.argtypes, name
