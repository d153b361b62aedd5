"""fftlab_torch.dist's pipelines against fftlab.dist, case for case of
tests/test_tp_pipeline.py (the gather-free TP filter) and
tests/test_pp_pipeline.py (the 4-stage PP pipeline over 1, 2 and 4
ranks).

The port's side runs in 8 gloo ranks on the CPU, started once for the
module (tests/_torch_dist_worker.py, suite "pipelines": a 1-D mesh "tp"
of 8, and "pp" meshes over the first 1, 2, 3 and 4 ranks); the JAX side
on conftest's 8 virtual devices, on the same float32 inputs. Gates:
>= 110 dB against the JAX function and against float64 numpy; refused
calls raise the same exception class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_dist_worker import run_ranks
from _torch_parity import snr_db
from fftlab.algos.split_stockham import spectral_filter_split
from fftlab.dist.pp_pipeline import pp_spectral_pipeline_split as jx_pp
from fftlab.dist.tp_pipeline import tp_spectral_filter_split as jx_tp

GATE = 110.0


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    try:
        return run_ranks("pipelines", 8, tmp_path_factory.mktemp("pipelines"))
    except RuntimeError as e:
        pytest.fail(str(e))


def case(res, name):
    if f"{name}/error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res[f'{name}/error']}")
    return {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(name + "/")}


@pytest.fixture(scope="module")
def tp8():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("tp",))


def planes(z):
    z = np.asarray(z)
    return (jnp.asarray(z.real.astype(np.float32)), jnp.asarray(z.imag.astype(np.float32)))


def jx_pair(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def spectral(x, h):
    """float64 ifft(fft(x) * H) along the last axis."""
    return np.fft.ifft(np.fft.fft(np.asarray(x, np.complex128), axis=-1)
                       * np.asarray(h, np.complex128), axis=-1)


# -- TP ------------------------------------------------------------------------


def test_tp_matches_unsharded(res, tp8):
    c = case(res, "tp_matches_unsharded")
    assert snr_db(c["y"], spectral(c["x"], c["h"])) >= GATE
    want = jx_pair(*spectral_filter_split(*planes(c["x"]), *planes(c["h"])))
    assert snr_db(c["y"], want) >= GATE
    assert snr_db(c["y"], jx_pair(*jx_tp(*planes(c["x"]), *planes(c["h"]), tp8,
                                         flatten=True))) >= GATE


def test_tp_identity_response_roundtrip(res):
    c = case(res, "tp_identity")
    assert snr_db(c["y"], c["x"]) >= GATE


def test_tp_output_block_matches_input_split(res, tp8):
    """The gather-free contract: the output is this rank's block
    [n2, n1/p] of the matrix, split as the input is."""
    c = case(res, "tp_block")
    assert tuple(c["block_shape"]) == (128, 16)
    yr, yi = jx_tp(*planes(c["x"]), *planes(c["h"]), tp8)
    assert yr.addressable_shards[0].data.shape == tuple(c["block_shape"])
    assert c["y"].shape == yr.shape == (128, 128)
    assert snr_db(c["y"], jx_pair(yr, yi)) >= GATE
    assert snr_db(c["y"].reshape(-1), spectral(c["x"], c["h"])) >= GATE


def test_tp_chained_filters_compose(res):
    c = case(res, "tp_chained")
    h = c["h"].astype(np.complex128)
    assert snr_db(c["y"], spectral(c["x"], h * h)) >= GATE
    want = jx_pair(*spectral_filter_split(*planes(c["x"]), *planes(h * h)))
    assert snr_db(c["y"], want) >= GATE


def test_tp_large_matches_unsharded(res):
    """The JAX suite's 16M ideal low-pass at 2^20 points."""
    c = case(res, "tp_large")
    assert snr_db(c["y"], spectral(c["x"], c["h"])) >= GATE
    want = jx_pair(*spectral_filter_split(*planes(c["x"]), *planes(c["h"])))
    assert snr_db(c["y"], want) >= GATE


def test_tp_indivisible_mesh_raises(res, tp8):
    z = jnp.zeros(144, jnp.float32)
    with pytest.raises(ValueError):
        jx_tp(z, z, jnp.ones(144, jnp.float32), z, tp8)
    assert str(case(res, "tp_indivisible")["raises"]) == "ValueError"


# -- PP ------------------------------------------------------------------------


def _reference(c, w, blocks=slice(None)):
    b = (c["br"][blocks] + 1j * c["bi"][blocks].astype(np.float64)) * w
    return spectral(b, c["hr"] + 1j * c["hi"].astype(np.float64))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_pp_matches_unsharded_every_depth(res, p):
    c = case(res, "pp")
    got = c[f"y{p}"]
    assert snr_db(got, _reference(c, c["w"])) >= GATE
    mesh = jax.make_mesh((p,), ("pp",))
    jx = jx_pair(*jx_pp(c["br"], c["bi"], c["hr"], c["hi"], mesh, axis_name="pp",
                        window=c["w"]))
    assert snr_db(got, jx) >= GATE


def test_pp_default_window_is_identity(res):
    c = case(res, "pp")
    assert snr_db(c["default_window"], _reference(c, 1.0)) >= GATE
    mesh = jax.make_mesh((4,), ("pp",))
    jx = jx_pair(*jx_pp(c["br"], c["bi"], c["hr"], c["hi"], mesh))
    assert snr_db(c["default_window"], jx) >= GATE


def test_pp_single_block_fill_drain(res):
    c = case(res, "pp")
    assert c["one_block"].shape == (1, 256)
    assert snr_db(c["one_block"], _reference(c, c["w"], slice(0, 1))) >= GATE


@pytest.mark.parametrize("key,match", [("divide", "divide"), ("blocks", "blocks"),
                                       ("window", "window"), ("response", "response")])
def test_pp_validation(res, key, match):
    c = case(res, "pp")
    br, bi, hr, hi, w = c["br"], c["bi"], c["hr"], c["hi"], c["w"]
    mesh = jax.make_mesh((4,), ("pp",))
    calls = {
        "divide": lambda: jx_pp(br, bi, hr, hi, jax.make_mesh((3,), ("pp",))),
        "blocks": lambda: jx_pp(br[0], bi[0], hr, hi, mesh),
        "window": lambda: jx_pp(br, bi, hr, hi, mesh, window=w[:-1]),
        "response": lambda: jx_pp(br, bi, hr[:-1], hi[:-1], mesh),
    }
    with pytest.raises(ValueError, match=match):
        calls[key]()
    assert str(c[key]) == "ValueError"
