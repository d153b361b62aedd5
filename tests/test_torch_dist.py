"""fftlab_torch.dist against fftlab.dist, case for case of
tests/test_dist.py: the complex four-step, the sharded plan, the
overlap-save filters and filterbank, Welch, the STFT, DP batches and the
mesh helpers.

The port's side runs in 8 gloo ranks on the CPU, started once for the
module (tests/_torch_dist_worker.py, suite "dist": a 1-D mesh "x" of 8
and a (dp=2, sp=4) mesh); the JAX side on conftest's 8 virtual devices,
on the same float32 / complex64 inputs. Gates: >= 110 dB against the JAX
function; against float64 oracles >= 120 dB for c2c, >= 110 dB for
Welch and the STFT, >= 100 dB for the FIR filters; refused calls raise
the same exception class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_ranks
from _torch_parity import snr_db
from fftlab.core.window import hann
from fftlab.dist.four_step import four_step_fft as jx_four_step_fft
from fftlab.dist.four_step import four_step_fft_sharded as jx_four_step_fft_sharded
from fftlab.dist.mesh import make_mesh as jx_make_mesh
from fftlab.dist.overlap_save import (overlap_save_filter_sharded as jx_os,
                                      overlap_save_filterbank_sharded as jx_bank)
from fftlab.dist.stft import stft_sharded as jx_stft
from fftlab.dist.welch import welch_psd_sharded as jx_welch
from fftlab.plan.api import plan_dft_1d_sharded as jx_plan
from fftlab_torch.dist import four_step as pt_four_step

GATE_JAX = 110.0
GATE_C2C = 120.0
GATE_SPECTRUM = 110.0
GATE_FIR = 100.0


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    try:
        return run_ranks("dist", 8, tmp_path_factory.mktemp("dist"))
    except RuntimeError as e:
        pytest.fail(str(e))


def case(res, name):
    if f"{name}/error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res[f'{name}/error']}")
    return {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(name + "/")}


@pytest.fixture(scope="module")
def mesh24():
    return jx_make_mesh({"dp": 2, "sp": 4})


def fir(x, h):
    """float64 np.convolve of every row, cut to the signal's length."""
    x, h = np.asarray(x, np.complex128), np.asarray(h, np.complex128)
    rows = x.reshape(-1, x.shape[-1])
    hs = h.reshape(-1, h.shape[-1])
    y = np.stack([np.convolve(r, hs[i % len(hs)])[:x.shape[-1]] for i, r in enumerate(rows)])
    return y.reshape(x.shape)


# -- four-step -----------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 256, 4096, 12 * 12])
def test_single_device_matches_oracle(n):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = pt_four_step.four_step_fft(torch.from_numpy(x)).numpy()
    assert snr_db(got, np.fft.fft(x.astype(np.complex128))) >= GATE_C2C
    assert snr_db(got, np.asarray(jx_four_step_fft(jnp.asarray(x)))) >= GATE_JAX


def test_single_device_inverse_roundtrip():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(np.complex64)
    y = pt_four_step.four_step_fft(pt_four_step.four_step_fft(torch.from_numpy(x)), 1).numpy()
    assert snr_db(y, x) >= GATE_C2C


@pytest.mark.parametrize("n", [4096, 65536])
def test_sharded_matches_single(res, mesh8, n):
    c = case(res, "sharded")
    x, y = c[f"x{n}"], c[f"y{n}"]
    assert snr_db(y, np.fft.fft(x.astype(np.complex128))) >= GATE_C2C
    assert snr_db(y, np.asarray(jx_four_step_fft_sharded(x, mesh8, axis_name="x"))) >= GATE_JAX
    assert snr_db(y, np.asarray(jx_four_step_fft(jnp.asarray(x)))) >= GATE_JAX


def test_sharded_inverse_scaling(res):
    c = case(res, "sharded_inverse")
    assert snr_db(c["back"], c["x"]) >= GATE_C2C


def test_sharded_batched(res, mesh8):
    c = case(res, "sharded_batched")
    assert c["y"].shape == (3, 4096)
    assert snr_db(c["y"], np.fft.fft(c["x"].astype(np.complex128))) >= GATE_C2C
    assert snr_db(c["y"], np.asarray(jx_four_step_fft_sharded(c["x"], mesh8, "x"))) >= GATE_JAX


def test_matrix_form_output(res, mesh8):
    c = case(res, "matrix_form")
    n1, n2 = pt_four_step.split_n(4096)
    assert tuple(c["block_shape"]) == (n1, n2 // 8)
    want = np.asarray(jx_four_step_fft_sharded(c["x"], mesh8, "x", flatten=False))
    assert c["y"].shape == want.shape == (n1, n2)
    assert snr_db(c["y"], want) >= GATE_JAX
    assert snr_db(c["y"], np.fft.fft(c["x"].astype(np.complex128)).reshape(n1, n2)) >= GATE_C2C


def test_split_n():
    assert pt_four_step.split_n(2**24) == (4096, 4096)
    assert pt_four_step.split_n(2**13) == (64, 128)
    assert pt_four_step.split_n(100, 10) == (10, 10)
    with pytest.raises(ValueError):
        pt_four_step.split_n(100, 7)


def test_indivisible_mesh_raises(res, mesh8):
    c = case(res, "indivisible")
    with pytest.raises(ValueError):
        jx_four_step_fft_sharded(jnp.zeros(36, jnp.complex64), mesh8, axis_name="x", n1=6)
    with pytest.raises(ValueError):
        jx_plan(36, mesh8, axis_name="x")
    assert str(c["four_step"]) == "ValueError"
    assert str(c["plan"]) == "ValueError"


# -- overlap-save --------------------------------------------------------------


@pytest.mark.parametrize("nh", [1, 7, 33, 129])
def test_overlap_save_matches_linear_convolution(res, mesh8, nh):
    c = case(res, "overlap_save")
    x, h, y = c["x"], c[f"h{nh}"], c[f"y{nh}"]
    assert y.dtype.kind == "f"
    assert snr_db(y, fir(x, h)) >= GATE_FIR
    assert snr_db(y, np.asarray(jx_os(x, h, mesh8, "x"))) >= GATE_JAX


@pytest.mark.parametrize("key", ["input", "taps"])
def test_overlap_save_complex(res, mesh8, key):
    c = case(res, "overlap_save_complex")
    x, h, y = c[f"{key}_x"], c[f"{key}_h"], c[f"{key}_y"]
    assert y.dtype.kind == "c"
    assert snr_db(y, fir(x, h)) >= GATE_FIR
    assert snr_db(y, np.asarray(jx_os(x, h, mesh8, "x"))) >= GATE_JAX


def test_overlap_save_batched_channels(res, mesh8):
    c = case(res, "overlap_save_batched")
    assert snr_db(c["y"], fir(c["x"], c["h"])) >= GATE_FIR
    assert snr_db(c["y"], np.asarray(jx_os(c["x"], c["h"], mesh8, "x"))) >= GATE_JAX


@pytest.mark.parametrize("key", ["real", "complex_taps"])
def test_filterbank_2d_mesh(res, mesh24, key):
    c = case(res, "filterbank")
    x, hb, y = c[f"{key}_x"], c[f"{key}_h"], c[f"{key}_y"]
    assert y.shape == x.shape
    for ch in range(x.shape[0]):
        assert snr_db(y[ch], fir(x[ch], hb[ch])) >= GATE_FIR, f"channel {ch}"
    assert snr_db(y, np.asarray(jx_bank(x, hb, mesh24))) >= GATE_JAX


def test_too_short_chunk_raises(res, mesh8, mesh24):
    c = case(res, "overlap_save_refusals")
    with pytest.raises(ValueError):
        jx_os(jnp.zeros(64), jnp.zeros(65), mesh8, "x")
    with pytest.raises(ValueError, match="halo"):
        jx_bank(jnp.zeros((2, 2048)), jnp.zeros((2, 1025)), mesh24)
    assert str(c["short"]) == "ValueError"
    assert str(c["bank_short"]) == "ValueError"


# -- Welch, STFT ---------------------------------------------------------------


def test_welch_matches_single_device(res, mesh8):
    from fftlab.dsp.spectrum import welch_psd

    c = case(res, "welch")
    f2, p2 = welch_psd(c["x"].astype(np.float64), sample_rate=1000.0, window_size=256,
                       overlap=0.5)
    np.testing.assert_allclose(c["freqs"], f2)
    assert snr_db(c["psd"], np.asarray(p2)) >= GATE_SPECTRUM
    _, pj = jx_welch(c["x"], mesh8, "x", sample_rate=1000.0, window_size=256, overlap=0.5)
    assert snr_db(c["psd"], np.asarray(pj)) >= GATE_JAX


def test_welch_tone_peak(res, mesh8):
    c = case(res, "welch")
    fs, f0 = 1024.0, 128.0
    assert abs(c["tone_freqs"][int(np.argmax(c["tone_psd"]))] - f0) < fs / 512
    _, pj = jx_welch(c["tone"], mesh8, "x", sample_rate=fs, window_size=512)
    assert snr_db(c["tone_psd"], np.asarray(pj)) >= GATE_JAX


def test_welch_rejects_batched_input(res, mesh8):
    with pytest.raises(ValueError, match="1D"):
        jx_welch(jnp.zeros((4, 8192)), mesh8, "x")
    assert str(case(res, "welch")["batched"]) == "ValueError"


def test_stft_matches_reference_framing(res, mesh8):
    c = case(res, "stft")
    n, fft_size, hop = 16384, 512, 256
    xp = np.pad(c["x"].astype(np.float64), (0, fft_size))
    w = hann(fft_size)
    want = np.stack([np.fft.fft(xp[k * hop:k * hop + fft_size] * w)[:fft_size // 2 + 1]
                     for k in range(n // hop)])
    assert c["S"].shape == (n // hop, fft_size // 2 + 1)
    assert snr_db(c["S"], want) >= GATE_SPECTRUM
    assert snr_db(c["S"], np.asarray(jx_stft(c["x"], mesh8, "x", fft_size, hop))) >= GATE_JAX


def test_stft_hop_equals_frame(res, mesh8):
    c = case(res, "stft")
    x = c["x2"].astype(np.float64)
    want = np.stack([np.fft.fft(x[k * 256:(k + 1) * 256])[:129] for k in range(32)])
    assert snr_db(c["S2"], want) >= GATE_SPECTRUM
    jx = jx_stft(c["x2"], mesh8, "x", 256, 256, window="rectangular")
    assert snr_db(c["S2"], np.asarray(jx)) >= GATE_JAX


# -- DP batches, the plan, the large transform, the mesh helpers ---------------


def test_dp_batched_fft(res, mesh8):
    from fftlab.algos.stockham import stockham_fft
    from fftlab.dist.mesh import shard_batch

    c = case(res, "dp_batched_fft")
    assert tuple(c["block_shape"]) == (1, 1024)
    want = np.asarray(jax.jit(stockham_fft)(shard_batch(c["x"], mesh8, "x")))
    assert snr_db(c["y"], want) >= GATE_JAX
    assert snr_db(c["y"], np.fft.fft(c["x"].astype(np.complex128))) >= GATE_C2C


def test_plan_executes_on_mesh(res, mesh8):
    c = case(res, "plan")
    jplan = jx_plan(4096, mesh8, axis_name="x")
    assert str(c["algorithm"]) == jplan.algorithm == "four_step[x=8]"
    assert snr_db(c["y"], np.fft.fft(c["x"].astype(np.complex128))) >= GATE_C2C
    assert snr_db(c["y"], np.asarray(jplan.execute(c["x"]))) >= GATE_JAX


def test_four_step_large_sharded(res):
    """The JAX suite's 16M two-tone check at 2^20 points: peaks of about
    n and n/2 at the tone bins, near zero elsewhere."""
    c = case(res, "large")
    n = int(c["n"])
    assert c["peak1"] > 0.9 * n
    assert c["peak2"] > 0.45 * n
    assert c["rest"] < 0.01 * n


def test_mesh_helpers(res):
    from fftlab.dist.mesh import make_mesh

    c = case(res, "mesh_helpers")
    np.testing.assert_array_equal(c["replicated"], c["rank0"])
    with pytest.raises(ValueError):
        make_mesh((2, 4))
    with pytest.raises(ValueError):
        make_mesh({"x": 16})
    assert str(c["tuple_shape"]) == "ValueError"
    assert str(c["too_big"]) == "ValueError"
