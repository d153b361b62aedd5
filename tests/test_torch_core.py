"""fftlab_torch core: import hygiene, types, owned tables, radix
planning, flags and the device report, held equal to the JAX package.

Tables are compared with np.array_equal: both packages build them in
float64 numpy with the same code, so they must agree bit for bit."""

import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fftlab.algos.stockham as jx_stockham
import fftlab.core.bitrev as jx_bitrev
import fftlab.core.framing as jx_framing
import fftlab.core.hostfft as jx_hostfft
import fftlab.core.twiddle as jx_twiddle
import fftlab.core.types as jx_types
import fftlab.core.window as jx_window
import fftlab.plan.flags as jx_flags
from fftlab_torch.algos import stockham
from fftlab_torch.core import bitrev, framing, hostfft, twiddle, types, window
from fftlab_torch.plan import flags, hardware

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fftlab_torch"


def test_import_loads_no_jax_triton_or_cuda():
    code = ("import sys, fftlab_torch, fftlab_torch.plan.api, "
            "fftlab_torch.plan.planner, fftlab_torch.plan.split_tuning, "
            "fftlab_torch.plan.wisdom, fftlab_torch.bench.timing, "
            "fftlab_torch.dist.four_step, fftlab_torch.algos.real_fft, "
            "fftlab_torch.kernels.fft_vmem, fftlab_torch.kernels.resident_vmem, "
            "fftlab_torch.kernels.os_filter_vmem, fftlab_torch.algos.bluestein, "
            "fftlab_torch.dsp.filtering, fftlab_torch.dsp.convolution, "
            "fftlab_torch.plan.filter_plan, fftlab_torch.core.hostfft, "
            "fftlab_torch.core.window, fftlab_torch.core.framing, "
            "fftlab_torch.core.bitrev, fftlab_torch.dist, fftlab_torch.dist.comm, "
            "fftlab_torch.dist.multihost, fftlab_torch.dist.fft2_mesh2d, "
            "fftlab_torch.dist.overlap_save, fftlab_torch.cli.dist_demo; "
            "bad = [m for m in ('jax', 'triton', 'fftlab') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax_or_fftlab(path):
    bad = re.compile(r"^\s*(import|from)\s+(jax|fftlab)(\.|\s|$)", re.M)
    assert not bad.search(path.read_text())


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|fftlab)(\.|\s|$)", src, re.M)


def test_chip_smoke_alone_refuses(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_direction_values():
    assert {d.name: int(d) for d in types.Direction} == {
        d.name: int(d) for d in jx_types.Direction}
    assert types.FORWARD == jx_types.FORWARD == -1
    assert types.INVERSE == jx_types.INVERSE == 1


def test_integer_helpers():
    for n in range(0, 4100):
        assert types.is_power_of_two(n) == jx_types.is_power_of_two(n)
        if jx_types.is_power_of_two(n):
            assert types.log2_int(n) == jx_types.log2_int(n)
    with pytest.raises(ValueError):
        types.log2_int(12)


@pytest.mark.parametrize("n", [1, 2, 8, 100, 128, 1024])
@pytest.mark.parametrize("direction", [-1, 1])
def test_dft_matrix_equal(n, direction):
    assert np.array_equal(twiddle.dft_matrix_np(n, direction),
                          jx_twiddle.dft_matrix_np(n, direction))


@pytest.mark.parametrize("r,m", [(2, 4), (64, 128), (128, 128), (3, 7), (8, 1024)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_stage_twiddle_equal(r, m, direction):
    assert np.array_equal(twiddle.stage_twiddle_np(r, m, direction),
                          jx_twiddle.stage_twiddle_np(r, m, direction))


@pytest.mark.parametrize("n", [1, 7, 64, 128, 1000, 4096, 6000, 1 << 15,
                               1 << 20, 1 << 21, 3 * 5 * 7 * 11 * 13])
@pytest.mark.parametrize("leaf", [128, 1024])
def test_plan_factors_equal(n, leaf):
    assert stockham.plan_factors(n, leaf) == jx_stockham.plan_factors(n, leaf)
    assert stockham.max_prime_factor(n) == jx_stockham.max_prime_factor(n)
    # the complex transform's stages: capped at STAGE_RADIX unless a
    # prime factor needs more, the same product
    stages = stockham.stage_factors(n, leaf)
    assert math.prod(stages) == n
    assert max(stages) <= max(stockham.STAGE_RADIX, stockham.max_prime_factor(n))


def test_plan_factors_refuses_large_prime():
    with pytest.raises(ValueError, match="Bluestein"):
        stockham.plan_factors(2 * 257, 128)


def test_flags_equal():
    assert {f.name: int(f) for f in flags.Flags} == {
        f.name: int(f) for f in jx_flags.Flags}
    cfg = flags.PlanConfig()
    assert cfg.flags == flags.Flags.ESTIMATE == jx_flags.PlanConfig().flags
    assert hash(cfg) == hash(flags.PlanConfig())


def test_detect_hardware_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    caps = hardware.detect_hardware()
    assert caps.platform == "cpu"
    assert caps.sm_count is None and "platform=cpu" in caps.summary()


def test_next_power_of_two():
    for n in range(-2, 5000):
        assert types.next_power_of_two(n) == jx_types.next_power_of_two(n)
    assert types.next_power_of_two(2 * 500009 - 1) == 1 << 20


@pytest.mark.parametrize("n", [1, 2, 7, 257, 10007, 500009])
@pytest.mark.parametrize("direction", [-1, 1])
def test_chirp_equal(n, direction):
    assert np.array_equal(twiddle.chirp_np(n, direction),
                          jx_twiddle.chirp_np(n, direction))


@pytest.mark.parametrize("n", [1, 2, 8, 1024, 1 << 15])
def test_bit_reverse_equal(n):
    assert np.array_equal(bitrev.bit_reverse_indices(n),
                          jx_bitrev.bit_reverse_indices(n))


@pytest.mark.parametrize("n", [1, 2, 8, 1000, 4096])
@pytest.mark.parametrize("direction", [-1, 1])
def test_twiddle_equal(n, direction):
    assert np.array_equal(twiddle.twiddle_np(n, direction),
                          jx_twiddle.twiddle_np(n, direction))
    assert np.array_equal(twiddle.butterfly_twiddle_np(n, direction),
                          jx_twiddle.butterfly_twiddle_np(n, direction))


@pytest.mark.parametrize("n,radix", [(1, 4), (4, 4), (64, 4), (4096, 4), (1024, 2),
                                     (729, 3), (1000, 10)])
def test_digit_reverse_equal(n, radix):
    assert np.array_equal(bitrev.digit_reverse_indices(n, radix),
                          jx_bitrev.digit_reverse_indices(n, radix))


def test_digit_reverse_refuses_other_sizes():
    with pytest.raises(ValueError, match="not a power of 4"):
        bitrev.digit_reverse_indices(32, 4)
    with pytest.raises(ValueError):
        jx_bitrev.digit_reverse_indices(32, 4)


def test_bit_reverse_refuses_other_sizes():
    with pytest.raises(ValueError, match="power-of-two"):
        bitrev.bit_reverse_indices(12)


@pytest.mark.parametrize("n", [1, 2, 64, 4096])
@pytest.mark.parametrize("direction", [-1, 1])
def test_host_fft_equal(n, direction):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    ours = hostfft.host_fft_pow2(x, direction)
    assert np.array_equal(ours, jx_hostfft.host_fft_pow2(x, direction))
    want = np.fft.fft(x) if direction == -1 else np.fft.ifft(x)
    assert np.allclose(ours, want, atol=1e-9)


@pytest.mark.parametrize("n,m", [(2, 4), (257, 1024), (10007, 1 << 15)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_bluestein_kernel_spectrum_equal(n, m, direction):
    assert np.array_equal(hostfft.bluestein_kernel_spectrum_np(n, m, direction),
                          jx_hostfft.bluestein_kernel_spectrum_np(n, m, direction))


@pytest.mark.parametrize("name", sorted(jx_window.WINDOWS))
@pytest.mark.parametrize("n", [1, 8, 129, 1024])
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_equal(name, n, periodic):
    assert np.array_equal(window.get_window(name, n, periodic),
                          jx_window.get_window(name, n, periodic))


def test_window_helpers_equal():
    assert np.array_equal(window.hamming(129, periodic=False),
                          jx_window.hamming(129, periodic=False))
    for alpha in (0.0, 0.3, 1.0):
        assert np.array_equal(window.tukey(64, alpha), jx_window.tukey(64, alpha))
    w = window.hann(256)
    assert window.coherent_gain(w) == jx_window.coherent_gain(w)
    assert window.power_gain(w) == jx_window.power_gain(w)
    with pytest.raises(ValueError, match="unknown window"):
        window.get_window("nope", 8)
    with pytest.raises(ValueError, match="expected"):
        window.get_window(np.ones(3), 8)
    got = window.get_window("hann", 8)
    got[:] = 0  # a copy: the cached window is untouched
    assert window.hann(8)[1] > 0


@pytest.mark.parametrize("total,frame,hop,n_frames", [(100, 16, 8, 11), (100, 16, 8, 20),
                                                      (100, 16, 8, 3), (1000, 128, 100, 9)])
def test_frame_signal_equal(total, frame, hop, n_frames):
    x = np.random.default_rng(total + hop).standard_normal((2, total)).astype(np.float32)
    got = framing.frame_signal_strided(torch.from_numpy(x), frame, hop, n_frames)
    want = np.asarray(jx_framing.frame_signal_strided(jnp.asarray(x), frame, hop,
                                                      n_frames))
    assert got.shape == want.shape == (2, n_frames, frame)
    assert np.array_equal(got.numpy(), want)


def test_frames_needed_and_refusal():
    for total, frame, hop in ((100, 16, 8), (10, 16, 8), (4096, 1024, 512)):
        assert framing.frames_needed(total, frame, hop) == jx_framing.frames_needed(
            total, frame, hop)
    with pytest.raises(ValueError, match="bad framing"):
        framing.frame_signal_strided(torch.zeros(10), 4, 0, 2)
