"""fftlab_torch.dist's split-plane layer against fftlab.dist, case for
case of tests/test_dist_split.py: the split four-step (with `chunks` and
`batch_axes`), the split overlap-save and filterbank, `FilterPlan(mesh=)`,
and the 2-D transforms over one mesh axis and over both axes of a 2-D
mesh.

The port's side runs in 8 gloo ranks on the CPU, started once for the
module (tests/_torch_dist_worker.py, suite "split": a 1-D mesh "x" of 8,
a (dp=2, sp=4) and an (a=2, b=4) mesh); the JAX side on conftest's 8
virtual devices, on the same float32 inputs. Gates: >= 110 dB against
the JAX function; against float64 oracles >= 120 dB for c2c, >= 110 dB
for the 2-D transforms, >= 100 dB for the FIR filters, over the whole
signal and over +-64 samples around every shard boundary; `chunks=K`
bit-identical to `chunks=1`; refused calls raise the same exception
class.
"""

import jax
import numpy as np
import pytest

from _torch_dist_worker import run_ranks
from _torch_parity import snr_db
from fftlab.dist.fft2_mesh2d import fft2_mesh2d_split as jx_mesh2d
from fftlab.dist.fft2_sharded import fft2_sharded_split as jx_fft2
from fftlab.dist.four_step_split import four_step_fft_sharded_split as jx_fs
from fftlab.dist.mesh import make_mesh as jx_make_mesh
from fftlab.dist.overlap_save_split import (
    overlap_save_filter_sharded_split as jx_os,
    overlap_save_filterbank_sharded_split as jx_bank,
)
from fftlab.plan.filter_plan import FilterPlan as JxFilterPlan

GATE_JAX = 110.0
GATE_C2C = 120.0
GATE_2D = 110.0
GATE_FIR = 100.0
SEAM = 64  # samples each side of a shard boundary the seam gate reads


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    try:
        return run_ranks("split", 8, tmp_path_factory.mktemp("split"))
    except RuntimeError as e:
        pytest.fail(str(e))


def case(res, name):
    if f"{name}/error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res[f'{name}/error']}")
    return {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(name + "/")}


@pytest.fixture(scope="module")
def mesh2d():
    return jax.make_mesh((2, 4), ("a", "b"))


def jx_pair(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def fir(x, h):
    """float64 np.convolve of every row, cut to the signal's length."""
    x = np.asarray(x, np.float64)
    rows = x.reshape(-1, x.shape[-1])
    y = np.stack([np.convolve(r, np.asarray(h, np.float64))[:x.shape[-1]] for r in rows])
    return y.reshape(x.shape)


def seams(y, want, p=8):
    """SNR over +-SEAM samples around every one of the p - 1 shard
    boundaries (the halo's work), and over the first SEAM samples."""
    n = y.shape[-1]
    idx = np.concatenate([np.arange(0, SEAM)]
                         + [np.arange(b - SEAM, b + SEAM) for b in range(n // p, n, n // p)])
    return snr_db(y[..., idx], want[..., idx])


# -- the split four-step --------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 65536])
def test_four_step_split_matches_complex_path(res, mesh8, n):
    from fftlab.dist.four_step import four_step_fft

    c = case(res, "four_step_split")
    x, y = c[f"x{n}"], c[f"y{n}"]
    assert snr_db(y, np.fft.fft(x)) >= GATE_C2C
    assert snr_db(y, np.asarray(four_step_fft(x.astype(np.complex64)))) >= GATE_JAX
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    assert snr_db(y, jx_pair(*jx_fs(xr, xi, mesh8, axis_name="x"))) >= GATE_JAX


@pytest.mark.parametrize("k", [2, 4])
def test_chunked_overlap_identical(res, mesh8, k):
    c = case(res, "chunks")
    assert bool(c[f"equal{k}"])
    np.testing.assert_array_equal(c[f"y{k}"], c["y1"])
    xr, xi = c["x"].real.astype(np.float32), c["x"].imag.astype(np.float32)
    assert snr_db(c[f"y{k}"], jx_pair(*jx_fs(xr, xi, mesh8, "x", chunks=k))) >= GATE_JAX
    assert snr_db(c[f"y{k}"], np.fft.fft(c["x"])) >= GATE_C2C


def test_chunks_must_divide(res, mesh8):
    x = np.zeros(1 << 14, np.float32)
    with pytest.raises(ValueError):
        jx_fs(x, x, mesh8, "x", chunks=7)
    assert str(case(res, "chunks")["seven"]) == "ValueError"


def test_four_step_split_inverse_roundtrip(res):
    c = case(res, "four_step_split_inverse")
    assert snr_db(c["back"], c["x"]) >= GATE_C2C


def test_four_step_split_matrix_form(res, mesh8):
    c = case(res, "four_step_split_matrix")
    assert tuple(c["block_shape"]) == (64, 8)
    yr, yi = jx_fs(c["x"], np.zeros_like(c["x"]), mesh8, "x", flatten=False)
    assert yr.shape == c["y"].shape == (64, 64)
    assert snr_db(c["y"], jx_pair(yr, yi)) >= GATE_JAX
    assert snr_db(c["y"], np.fft.fft(c["x"].astype(np.float64)).reshape(64, 64)) >= GATE_C2C


# -- overlap-save, the filterbank, FilterPlan(mesh=) ------------------------------


@pytest.mark.parametrize("nh", [7, 65])
def test_two_channels_for_one(res, mesh8, nh):
    c = case(res, "overlap_save_split")
    a, b, h, y = c[f"a{nh}"], c[f"b{nh}"], c[f"h{nh}"], c[f"y{nh}"]
    want = fir(a, h) + 1j * fir(b, h)
    assert snr_db(y, want) >= GATE_FIR
    assert seams(y, want) >= GATE_FIR
    assert snr_db(y, jx_pair(*jx_os(a, b, h, mesh8, "x"))) >= GATE_JAX


def test_overlap_save_split_batched(res, mesh8):
    c = case(res, "overlap_save_split")
    x, h, y = c["batched_x"], c["batched_h"], c["batched_y"]
    assert snr_db(y, fir(x, h)) >= GATE_FIR
    assert seams(y, fir(x, h)) >= GATE_FIR
    assert snr_db(y, np.asarray(jx_os(x, np.zeros_like(x), h, mesh8, "x")[0])) >= GATE_JAX


def test_overlap_save_split_validation(res, mesh8):
    z = np.zeros(64, np.float32)
    with pytest.raises(ValueError):
        jx_os(z, z, np.zeros(65, np.float32), mesh8, "x")
    assert str(case(res, "overlap_save_split")["short"]) == "ValueError"


def test_filterbank_matches_per_channel_convolution(res):
    c = case(res, "filterbank_split")
    x, hb, y = c["x"], c["h"], c["y"]
    for ch in range(x.shape[0]):
        want = fir(x[ch], hb[ch])
        assert snr_db(y[ch], want) >= GATE_FIR, f"channel {ch}"
        assert seams(y[ch], want, p=4) >= GATE_FIR, f"channel {ch}"
    jx = np.asarray(jx_bank(x, hb, jx_make_mesh({"dp": 2, "sp": 4})))
    assert snr_db(y, jx) >= GATE_JAX


@pytest.mark.parametrize("nh", [129, 33])
def test_filter_plan_mesh(res, mesh8, nh):
    """FilterPlan(h, mesh=, time_axis=) against the JAX mesh plan, one
    real channel and a packed pair, seams included."""
    c = case(res, "filter_plan_mesh")
    x, x2, h = c[f"x{nh}"], c[f"x2_{nh}"], c[f"h{nh}"]
    jplan = JxFilterPlan(h, mesh=mesh8, time_axis="x")
    want = fir(x, h)
    assert snr_db(c[f"y{nh}"], want) >= GATE_FIR
    assert seams(c[f"y{nh}"], want) >= GATE_FIR
    assert snr_db(c[f"y{nh}"], np.asarray(jplan(x))) >= GATE_JAX
    want2 = want + 1j * fir(x2, h)
    assert snr_db(c[f"pair{nh}"], want2) >= GATE_FIR
    assert seams(c[f"pair{nh}"], want2) >= GATE_FIR
    assert snr_db(c[f"pair{nh}"], jx_pair(*jplan(x, x2))) >= GATE_JAX
    assert "mesh[x]=8" in str(c[f"describe{nh}"])


# -- the 2-D transforms --------------------------------------------------------


def test_fft2_matches_numpy(res, mesh8):
    c = case(res, "fft2")
    assert snr_db(c["y"], np.fft.fft2(c["x"])) >= GATE_2D
    xr, xi = c["x"].real.astype(np.float32), c["x"].imag.astype(np.float32)
    assert snr_db(c["y"], jx_pair(*jx_fft2(xr, xi, mesh8, "x"))) >= GATE_JAX


@pytest.mark.parametrize("k", [2, 4])
def test_fft2_chunked_overlap_identical(res, k):
    assert bool(case(res, "fft2")[f"equal{k}"])


def test_fft2_chunks_must_divide(res, mesh8):
    x = np.zeros((64, 128), np.float32)
    with pytest.raises(ValueError):
        jx_fft2(x, x, mesh8, "x", chunks=3)
    assert str(case(res, "fft2")["three"]) == "ValueError"


def test_fft2_transposed_out(res, mesh8):
    c = case(res, "fft2")
    got = c["t_y"].T
    assert snr_db(got, np.fft.fft2(c["t_x"].astype(np.float64))) >= GATE_2D
    jx = jx_pair(*jx_fft2(c["t_x"], np.zeros_like(c["t_x"]), mesh8, "x",
                          transposed_out=True))
    assert snr_db(c["t_y"], jx) >= GATE_JAX


def test_fft2_inverse_roundtrip(res):
    c = case(res, "fft2")
    assert snr_db(c["rt_back"], c["rt_x"]) >= GATE_2D


def test_fft2_indivisible_raises(res, mesh8):
    with pytest.raises(ValueError):
        jx_fft2(np.zeros((30, 64)), np.zeros((30, 64)), mesh8, "x")
    assert str(case(res, "fft2")["indivisible"]) == "ValueError"


def test_mesh2d_matches_numpy_fft2(res, mesh2d):
    c = case(res, "mesh2d")
    x = c["x"]
    assert snr_db(c["y"], np.fft.fft2(x.astype(np.complex128))) >= GATE_2D
    jx = jx_pair(*jx_mesh2d(x.real.copy(), x.imag.copy(), mesh2d, "a", "b"))
    assert snr_db(c["y"], jx) >= GATE_JAX


def test_mesh2d_inverse_roundtrip(res):
    c = case(res, "mesh2d")
    assert snr_db(c["rt_back"], c["rt_x"]) >= GATE_2D


def test_mesh2d_unflattened_block_form(res, mesh2d):
    """flatten=False returns this rank's block [c1, c2/pc, r1, r2/pa] of
    the factor matrix; gathered, its documented indexing rebuilds the
    spectrum."""
    from fftlab.dist.four_step import split_n

    c = case(res, "mesh2d")
    R, C = 32, 64
    r1, r2 = split_n(R)
    c1, c2 = split_n(C)
    assert tuple(c["block_shape"]) == (c1, c2 // 4, r1, r2 // 2)
    assert c["block_w"].shape == (c1, c2, r1, r2)
    got = c["block_w"].reshape(C, R).T
    assert snr_db(got, np.fft.fft2(c["block_x"].astype(np.complex128))) >= GATE_2D
    u = c["block_x"]
    wr, wi = jx_mesh2d(u.real.copy(), u.imag.copy(), mesh2d, "a", "b", flatten=False)
    assert snr_db(c["block_w"], jx_pair(wr, wi)) >= GATE_JAX


def test_mesh2d_matches_pencil_decomposition(res):
    c = case(res, "mesh2d")
    assert snr_db(c["pencil_mesh2d"], c["pencil_1d"]) >= GATE_2D
    assert snr_db(c["pencil_mesh2d"], np.fft.fft2(c["pencil_x"])) >= GATE_2D


def test_mesh2d_indivisible_raises(res, mesh2d):
    z = np.zeros((30, 64), np.float32)
    with pytest.raises(ValueError):
        jx_mesh2d(z, z, mesh2d, "a", "b")
    assert str(case(res, "mesh2d")["indivisible"]) == "ValueError"


@pytest.mark.parametrize("key,batch_axes,rows",
                         [("twice", ("a", "a"), 4), ("reuse", ("b",), 4),
                          ("indivisible", ("a",), 3)])
def test_batch_axes_validation(res, mesh2d, key, batch_axes, rows):
    xr = np.zeros((rows, 64), np.float32)
    with pytest.raises(ValueError):
        jx_fs(xr, xr, mesh2d, "b", batch_axes=batch_axes)
    assert str(case(res, "batch_axes")[key]) == "ValueError"
