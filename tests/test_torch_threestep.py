"""fftlab_torch's three-pass FFT (kernels/threestep_vmem.py, the
`three_pass` route) against the JAX package on the same float32 inputs:
the plain passes against float64 numpy versions of each pass's math,
the whole transform against the JAX kernel in interpret mode at 2^21 and
2^22 (row-major, and the blocked default, the same math) and against the
JAX einsum route above, the route table, and the real-signal wrappers at
n = 2^23, whose half size runs the three-pass kernel on both sides. The
CUDA kernels are tested on the card by tests/test_torch_cuda.py.

Gates: >= 120 dB SNR for the c2c transform and each pass (the JAX suite's
c2c gate, tests/test_resident_vmem.py:37; interpret-mode JAX reads
134 dB, threestep_vmem.py:51-56), >= 110 dB for the real-signal path
(tests/test_rfft_resident.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.threestep_vmem as jx_ts
import fftlab.plan.dispatch as jx_dispatch
from _torch_parity import CASE_IDS, CASES, cplx, oracle, planes, snr_db, tt, whole_scale
from fftlab.algos import split_stockham as jx_split
import fftlab_torch
from fftlab_torch.kernels import fourstep_vmem, threestep_vmem
from fftlab_torch.plan import api, dispatch


@pytest.fixture(autouse=True)
def _no_forced_route(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)


@pytest.mark.parametrize("e", range(19, 28))
def test_split_three_and_window_equal(e):
    n = 1 << e
    assert threestep_vmem.supported_huge(n) == jx_ts.supported_huge(n)
    if jx_ts.supported_huge(n):
        assert threestep_vmem._split_three(n) == jx_ts._split_three(n)


@pytest.mark.parametrize("e", range(21, 27))
def test_pass_tiles_fit_the_kernels(e):
    """Each launch's tile is within the register engine's range
    (csrc/fft_reg.cuh valid_geometry: sides 128..16384, 512..16384
    values, at most 1024 threads): F1 and F2 columns in passes A and B,
    R rows of F3 in pass C, at the wrappers' geometry."""
    F1, F2, F3 = threestep_vmem._split_three(1 << e)
    for geo in (fourstep_vmem.pass1_geometry(F1, F2 * F3), fourstep_vmem.pass1_geometry(F2, F3),
                fourstep_vmem.pass2_geometry(F1 * F2, F3)):
        assert 128 <= geo.L <= 16384
        assert 512 <= geo.T * geo.L <= 16384 and geo.threads <= 1024


@pytest.mark.parametrize("n,blocked", [(1 << 21, False), (1 << 22, False),
                                       (1 << 22, True)],
                         ids=["2^21", "2^22", "2^22-blocked"])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_plain_matches_jax_interpret(n, blocked, direction, scale):
    xr, xi = planes(n % 1009 + direction, (1, n))
    got = cplx(*threestep_vmem.fft_split_huge(tt(xr), tt(xi), direction, scale=scale))
    want = cplx(*jx_ts.fft_split_huge(xr, xi, direction, interpret=True,
                                      blocked=blocked, scale=scale))
    assert snr_db(got, want) >= 120.0
    assert snr_db(got, oracle(xr, xi, direction, whole_scale(n, direction, scale))) >= 120.0


def test_plain_matches_jax_einsum_above_2_22():
    n = 1 << 23
    xr, xi = planes(23, (1, n))
    got = cplx(*threestep_vmem.fft_split_huge(tt(xr), tt(xi)))
    want = cplx(*jx_split.fft_split(jnp.asarray(xr), jnp.asarray(xi)))
    assert snr_db(got, want) >= 120.0
    assert snr_db(got, oracle(xr, xi, -1)) >= 120.0


def _np_pass(x, direction, L1, L2):
    """float64 pass-1 math on (B, L1*L2): FFT over the L1 axis, times
    W_{L1L2}^{k1*j2}."""
    B = x.shape[0]
    x3 = x.reshape(B, L1, L2)
    y = np.fft.fft(x3, axis=1) if direction == -1 else np.fft.ifft(x3, axis=1) * L1
    k1 = np.arange(L1)[:, None]
    j2 = np.arange(L2)[None, :]
    return (y * np.exp(2j * np.pi * direction * (k1 * j2 % (L1 * L2)) / (L1 * L2))).reshape(B, -1)


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("which", ["a", "b", "c"])
def test_plain_passes_match_float64(which, direction):
    n = 1 << 21
    F1, F2, F3 = threestep_vmem._split_three(n)
    xr, xi = planes(7 + direction, (2, n))
    x = xr + 1j * xi.astype(np.float64)
    if which == "a":
        got = threestep_vmem.threestep_pass_a_plain(tt(xr), tt(xi), direction)
        want = _np_pass(x, direction, F1, F2 * F3)
    elif which == "b":
        got = threestep_vmem.threestep_pass_b_plain(tt(xr), tt(xi), direction)
        y = _np_pass(x.reshape(2 * F1, F2 * F3), direction, F2, F3)
        want = y.reshape(2, F1, F2, F3).transpose(0, 2, 1, 3).reshape(2, n)
    else:
        got = threestep_vmem.threestep_pass_c_plain(tt(xr), tt(xi), direction, 0.5)
        rows = x.reshape(2 * F2 * F1, F3)
        y = np.fft.fft(rows) if direction == -1 else np.fft.ifft(rows) * F3
        # row (b, k2, k1), bin k3 -> k3*F1F2 + k2*F1 + k1
        want = 0.5 * y.reshape(2, F2 * F1, F3).transpose(0, 2, 1).reshape(2, n)
    assert snr_db(cplx(*got), want) >= 120.0


def test_batch_dims_and_round_trip():
    n = 1 << 21
    xr, xi = planes(3, (2, 1, n))
    yr, yi = threestep_vmem.fft_split_huge(tt(xr), tt(xi))
    assert yr.shape == (2, 1, n) and yr.dtype == torch.float32
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 120.0
    br, bi = threestep_vmem.fft_split_huge(yr, yi, fftlab_torch.INVERSE)
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= 120.0


@pytest.mark.parametrize("n", [1 << 20, 1 << 27, 3 << 21])
def test_refuses_sizes_outside_window(n):
    with pytest.raises(ValueError, match="supports pow2 n"):
        threestep_vmem.fft_split_huge(torch.zeros(1, n), torch.zeros(1, n))


def test_refuses_other_dtypes():
    x = torch.zeros(1, 1 << 21, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        threestep_vmem.fft_split_huge(x, x)


@pytest.mark.parametrize("launch", [threestep_vmem.threestep_pass_a,
                                    threestep_vmem.threestep_pass_b,
                                    threestep_vmem.threestep_pass_c],
                         ids=["a", "b", "c"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """A kernel wrapper launches or raises: it never runs the plain
    version for a tensor it cannot launch on."""
    x = torch.zeros(1, 1 << 21)
    with pytest.raises(ValueError, match="CUDA kernel"):
        launch(x, x)


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("n", [1 << 22, 1 << 23, 1 << 24, 1 << 25, 1 << 26])
def test_route_is_three_pass(n):
    assert dispatch.select_split_impl(n) == "three_pass"
    assert fftlab_torch.plan_dft_1d_split(n).algorithm == "three_pass"


def test_plan_and_auto_match_jax_at_2_22():
    n = 1 << 22
    xr, xi = planes(22, (1, n))
    plan = fftlab_torch.plan_dft_1d_split(n)
    assert plan.algorithm == "three_pass"
    got = cplx(*plan.execute((tt(xr), tt(xi))))
    auto = cplx(*fftlab_torch.fft_split_auto(tt(xr), tt(xi)))
    want = cplx(*jx_dispatch.fft_split_auto(jnp.asarray(xr), jnp.asarray(xi)))
    assert snr_db(got, want) >= 120.0
    assert snr_db(auto, want) >= 120.0
    assert snr_db(got, oracle(xr, xi, -1)) >= 120.0


def test_plan_from_jax_threestep():
    plan = api.plan_from_jax("threestep_vmem", 1 << 22, 1)
    assert plan.algorithm == "three_pass" and plan.direction == fftlab_torch.INVERSE


def test_run_route_scale():
    n = 1 << 21
    xr, xi = planes(5, (1, n))
    got = cplx(*dispatch.run_route("three_pass", tt(xr), tt(xi), 1, scale=0.25))
    assert snr_db(got, oracle(xr, xi, 1, 0.25 / n)) >= 120.0


def test_real_wrappers_match_jax_at_2_23():
    n = 1 << 23
    x = np.random.default_rng(8).standard_normal((1, n)).astype(np.float32)
    got = fourstep_vmem.rfft_split_large(tt(x))
    want = jx_fs.rfft_split_large(x, interpret=True)
    assert snr_db(cplx(*got), cplx(*want)) >= 110.0
    assert snr_db(cplx(*got), np.fft.rfft(x.astype(np.float64))) >= 110.0
    back = fourstep_vmem.irfft_split_large(*got).numpy()
    jback = np.asarray(jx_fs.irfft_split_large(*want, interpret=True))
    assert snr_db(back, jback) >= 110.0
    assert snr_db(back, x.astype(np.float64)) >= 110.0


def test_real_plans_at_2_23_run_three_pass():
    n = 1 << 23
    r2c = fftlab_torch.plan_r2c_1d_split(n)
    c2r = fftlab_torch.plan_c2r_1d_split(n)
    assert r2c.algorithm == "rfft_split[three_pass]"
    assert c2r.algorithm == "irfft_split[three_pass]"
    x = np.random.default_rng(9).standard_normal((1, n)).astype(np.float32)
    X = r2c.execute(tt(x))
    assert snr_db(cplx(*X), np.fft.rfft(x.astype(np.float64))) >= 110.0
    assert snr_db(c2r.execute(X).numpy(), x.astype(np.float64)) >= 110.0


def test_exported():
    assert fftlab_torch.fft_split_huge is threestep_vmem.fft_split_huge
