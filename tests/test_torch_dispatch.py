"""fftlab_torch.plan: the route table, FFTLAB_FORCE_IMPL, split plans,
plan_from_jax and the slice end to end against fftlab's split plans on
the same float32 inputs.

Gates: port vs the float64 numpy oracle >= 120 dB SNR (>= 110 dB on the
`smem_rows` route); port vs JAX >= 110 dB. Both sides are float32 with
different summation orders; the gates are the JAX suite's own
(tests/test_resident_vmem.py:37, tests/test_kernels.py:39)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.plan.api as jx_api
import fftlab.plan.dispatch as jx_dispatch
from fftlab.kernels.fft_vmem import pallas_fft_split
import fftlab_torch
from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab_torch.plan import api, dispatch
from fftlab_torch.plan.flags import Flags


@pytest.fixture(autouse=True)
def _no_forced_route(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)


ROUTE_TABLE = [(4096, "einsum"), (8192, "smem_rows"), (16384, "smem_rows"),
               (1 << 15, "two_pass"), (1 << 20, "two_pass"),
               (1 << 21, "two_pass"), (1 << 22, "three_pass"), (1 << 26, "three_pass"),
               (1 << 27, "einsum"), (1000, "einsum")]


@pytest.mark.parametrize("n,route", ROUTE_TABLE)
def test_route_table(n, route):
    assert dispatch.select_split_impl(n) == route
    assert dispatch.select_split_impl(n, batch=64) == route  # n only
    assert fftlab_torch.plan_dft_1d_split(n, batch=4).algorithm == route


@pytest.mark.parametrize("route", dispatch.ROUTES)
def test_force_impl(monkeypatch, route):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", route)
    assert dispatch.select_split_impl(1 << 15) == route
    assert fftlab_torch.plan_dft_1d_split(1 << 15).algorithm == route


@pytest.mark.parametrize("bad", ["resident_v6", "pallas_vmem", "cufft", "EINSUM"])
def test_force_impl_unknown_raises(monkeypatch, bad):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", bad)
    with pytest.raises(ValueError, match="FFTLAB_FORCE_IMPL"):
        dispatch.select_split_impl(8192)


def test_run_route_unknown_raises():
    x = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="unknown route"):
        dispatch.run_route("resident_v6", x, x, -1)


JAX_TO_PORT = {
    "pallas_vmem": "smem_rows", "resident_vmem": "two_pass",
    "resident_v4": "two_pass", "resident_v6": "two_pass",
    "resident_v4_3x": "two_pass", "resident_v6_3x": "two_pass",
    "resident_cio": "two_pass", "fourstep_vmem": "two_pass",
    "threestep_vmem": "three_pass", "pallas_pipeline": "stage_pipeline",
    "einsum": "einsum",
}


@pytest.mark.parametrize("route", jx_dispatch.ROUTES)
def test_plan_from_jax_every_route(route):
    n = {"pallas_vmem": 8192, "threestep_vmem": 1 << 22}.get(route, 1 << 15)
    plan = api.plan_from_jax(route, n, -1)
    assert plan.algorithm == JAX_TO_PORT[route] and plan.n == n
    assert plan.direction == fftlab_torch.FORWARD


@pytest.mark.parametrize("route,n,want", [("threestep_vmem", 1 << 22, "three_pass"),
                                          ("threestep_vmem", 1 << 21, "three_pass"),
                                          ("pallas_pipeline", 16384, "stage_pipeline"),
                                          ("pallas_pipeline", 1 << 17, "stage_pipeline")])
def test_plan_from_jax_unported_kernels(route, n, want):
    """The JAX kernel routes ported last map by name, at any n of theirs."""
    assert api.plan_from_jax(route, n, 1).algorithm == want


def test_plan_from_jax_unknown_raises():
    with pytest.raises(ValueError, match="unknown JAX split route"):
        api.plan_from_jax("smem_rows", 8192, -1)


@pytest.mark.parametrize("jax_route,n", [("resident_v6", 1 << 15),
                                         ("pallas_vmem", 8192),
                                         ("fourstep_vmem", 1 << 15)])
def test_plan_from_jax_carries_a_jax_plan(monkeypatch, jax_route, n):
    """A JAX plan, read as plain values, becomes a port plan that computes
    the same transform."""
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", jax_route)
    jplan = jx_api.plan_dft_1d_split(n, jx_api.INVERSE)
    monkeypatch.delenv("FFTLAB_FORCE_IMPL")
    plan = api.plan_from_jax(jplan.algorithm, jplan.n, int(jplan.direction))
    assert plan.algorithm == JAX_TO_PORT[jax_route]
    xr, xi = planes(n, (2, n))
    got = cplx(*plan.execute((tt(xr), tt(xi))))
    if jax_route == "pallas_vmem":
        # the JAX row-kernel route compiles only for a TPU; on the CPU its
        # kernel runs in interpret mode
        want = cplx(*pallas_fft_split(jnp.asarray(xr), jnp.asarray(xi),
                                      jplan.direction, interpret=True))
    else:
        want = cplx(*jplan.execute((jnp.asarray(xr), jnp.asarray(xi))))
    assert snr_db(got, want) >= 110.0


@pytest.mark.parametrize("flag", [Flags.MEASURE, Flags.PATIENT,
                                  Flags.EXHAUSTIVE, Flags.WISDOM_ONLY])
def test_measuring_flags_not_ported(flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        fftlab_torch.plan_dft_1d_split(1 << 15, flags=flag)


def test_force_impl_outranks_flags(monkeypatch):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", "einsum")
    plan = fftlab_torch.plan_dft_1d_split(1 << 15, flags=Flags.MEASURE)
    assert plan.algorithm == "einsum"


@pytest.mark.parametrize("n", [8192, 1 << 15, 1 << 17])
def test_slice_end_to_end_matches_jax(n):
    """plan_dft_1d_split forward then inverse on CPU tensors vs the JAX
    package's split plans on the same inputs."""
    xr, xi = planes(n + 17, (4, n))
    fwd = fftlab_torch.plan_dft_1d_split(n, batch=4)
    inv = fftlab_torch.plan_dft_1d_split(n, fftlab_torch.INVERSE, batch=4)
    yr, yi = fwd.execute((tt(xr), tt(xi)))
    jfwd = jx_api.plan_dft_1d_split(n)
    jinv = jx_api.plan_dft_1d_split(n, jx_api.INVERSE)
    jr, ji = jfwd.execute((jnp.asarray(xr), jnp.asarray(xi)))
    gate = 110.0 if fwd.algorithm == "smem_rows" else 120.0
    assert snr_db(cplx(yr, yi), cplx(jr, ji)) >= 110.0
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= gate
    br, bi = inv.execute((yr, yi))
    kr, ki = jinv.execute((jr, ji))
    assert snr_db(cplx(br, bi), cplx(kr, ki)) >= 110.0
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= gate


@pytest.mark.parametrize("n", [4096, 8192, 1 << 15])
def test_run_route_scale(n):
    xr, xi = planes(3, (2, n))
    route = dispatch.select_split_impl(n)
    got = cplx(*dispatch.run_route(route, tt(xr), tt(xi), 1, scale=0.25))
    want = cplx(*jx_dispatch.run_route("einsum", jnp.asarray(xr),
                                       jnp.asarray(xi), 1, scale=0.25))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, 1, 0.25 / n)) >= 110.0


def test_fft_split_auto_defaults_forward():
    xr, xi = planes(4, (2, 2, 16384))
    yr, yi = fftlab_torch.fft_split_auto(tt(xr), tt(xi))
    assert yr.shape == (2, 2, 16384)
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 110.0


def test_plan_describe():
    plan = fftlab_torch.plan_dft_1d_split(1 << 15, fftlab_torch.INVERSE)
    assert plan.describe() == ("Plan(kind=c2c_split, n=32768, dir=INVERSE, "
                               "algorithm=two_pass)")
