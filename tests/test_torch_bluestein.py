"""fftlab_torch Bluestein (chirp-z) transform against the JAX package's.

Sizes with a prime factor above the leaf (257, 2*131, 10007) go through
`fft_split`, `fft_split_auto` and `plan_dft_1d_split(...).execute` and
come back as the transform, where the port once raised. Inputs are
float32 from a numpy seed (tests/conftest.py turns on jax x64, so they
are cast).

Gates: port vs the float64 numpy oracle >= 95 dB SNR and port vs JAX
`fft_split` >= 95 dB: the JAX suite's float32 Bluestein gate
(tests/test_split.py:272). The plan-time constants are built from the
same float64 numpy on both sides and must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

import fftlab.algos.bluestein as jx_bluestein
import fftlab_torch
from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab.algos.split_stockham import fft_split as jx_fft_split
from fftlab_torch.algos import bluestein
from fftlab_torch.core.types import next_power_of_two
from fftlab_torch.plan import dispatch

SIZES = [257, 2 * 131, 10007]
GATE_DB = 95.0


@pytest.fixture(autouse=True)
def _no_forced_route(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)


def _entry_points(n, direction):
    plan = fftlab_torch.plan_dft_1d_split(n, direction, batch=2)
    return {
        "fft_split": lambda a, b: fftlab_torch.fft_split(a, b, direction),
        "fft_split_auto": lambda a, b: fftlab_torch.fft_split_auto(a, b, direction),
        "plan": lambda a, b: plan.execute((a, b)),
    }


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("direction", [-1, 1], ids=["fwd", "inv"])
@pytest.mark.parametrize("entry", ["fft_split", "fft_split_auto", "plan"])
def test_prime_sizes_match_jax(n, direction, entry):
    xr, xi = planes(n + direction, (2, n))
    got = cplx(*_entry_points(n, direction)[entry](tt(xr), tt(xi)))
    want = cplx(*jx_fft_split(jnp.asarray(xr), jnp.asarray(xi), direction))
    scale = 1.0 / n if direction == 1 else 1.0
    assert got.shape == (2, n)
    assert snr_db(got, oracle(xr, xi, direction, scale)) >= GATE_DB
    assert snr_db(got, want) >= GATE_DB


@pytest.mark.parametrize("n", [5, 257, 10007])
def test_bluestein_fft_split_matches_jax(n):
    xr, xi = planes(3 * n, (3, n))
    got = cplx(*fftlab_torch.bluestein_fft_split(tt(xr), tt(xi)))
    want = cplx(*jx_bluestein.bluestein_fft_split(jnp.asarray(xr),
                                                  jnp.asarray(xi)))
    assert snr_db(got, want) >= GATE_DB
    assert snr_db(got, oracle(xr, xi, -1)) >= GATE_DB


def test_round_trip():
    n = 10007
    xr, xi = planes(1, (2, n))
    yr, yi = fftlab_torch.fft_split(tt(xr), tt(xi))
    br, bi = fftlab_torch.fft_split(yr, yi, fftlab_torch.INVERSE)
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= GATE_DB


def test_length_one_is_identity():
    xr, xi = planes(2, (2, 1))
    yr, yi = bluestein.bluestein_fft_split(tt(xr), tt(xi))
    assert np.array_equal(yr.numpy(), xr) and np.array_equal(yi.numpy(), xi)


@pytest.mark.parametrize("n", [257, 262, 10007])
@pytest.mark.parametrize("direction", [-1, 1])
def test_kernel_planes_equal(n, direction):
    m = next_power_of_two(2 * n - 1)
    ours = bluestein._kernel_planes_np(n, m, direction, "<f4")
    theirs = jx_bluestein._kernel_planes_np(n, m, direction, "<f4")
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("n,route", [(257, "smem_rows"), (262, "smem_rows"),
                                     (10007, "two_pass"), (100, "einsum")])
def test_convolution_route(n, route):
    """The convolution at m = next_pow2(2n-1) takes the sandwich route of
    m: the row kernel to 16K, the two-pass sandwich from 2^15."""
    m = next_power_of_two(2 * n - 1)
    assert dispatch.select_filter_impl(m) == route


def test_conv_sandwich_refuses_wrong_size():
    x = tt(np.zeros((1, 1000), np.float32))
    with pytest.raises(ValueError, match="want 1024"):
        bluestein._conv_sandwich_split(x, x, np.ones(1024), np.zeros(1024), 1024)
