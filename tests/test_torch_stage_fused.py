"""fftlab_torch's fused radix stage and the stage pipeline
(kernels/stage_fused.py, the `stage_pipeline` route) against the JAX
package on the same float32 inputs: the plain `fused_stage` against the
JAX kernel in interpret mode, `fft_split_pipeline` and
`run_route("stage_pipeline")` against the JAX `fft_split_pipeline` and
`run_route("pallas_pipeline")` (its kernel in interpret mode: on the CPU
the JAX route compiles only so), and `pipeline_factors`. The CUDA kernel
is tested on the card by tests/test_torch_cuda.py.

Gates: >= 115 dB SNR for a stage (tests/test_stage_fused.py:31) and for
the pipeline against JAX; >= 110 dB for the pipeline against float64
(tests/test_stage_fused.py:60)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.kernels.stage_fused as jx_sf
import fftlab.plan.dispatch as jx_dispatch
from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.kernels import stage_fused
from fftlab_torch.plan import api, dispatch

STAGES = [(64, 2048), (128, 1024), (32, 128), (2, 128)]


def _stage_oracle(xr, xi, r, direction, twiddle):
    B, n = xr.shape
    x = (xr + 1j * xi.astype(np.float64)).reshape(B, r, n // r)
    y = np.einsum("ba,Bam->Bbm", dft_matrix_np(r, direction), x)
    if twiddle:
        y = y * stage_twiddle_np(r, n // r, direction)
    return y.reshape(B, n)


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("r,M", STAGES)
def test_fused_stage_matches_jax_interpret(r, M, direction):
    xr, xi = planes(r + M + direction, (2, r * M))
    got = cplx(*stage_fused.fused_stage(tt(xr), tt(xi), r, direction))
    want = cplx(*jx_sf.fused_stage(jnp.asarray(xr), jnp.asarray(xi), r=r,
                                   direction=direction, interpret=True))
    assert snr_db(got, want) >= 115.0
    assert snr_db(got, _stage_oracle(xr, xi, r, direction, True)) >= 115.0


@pytest.mark.parametrize("r,M", [(64, 256), (2, 128)])
def test_fused_stage_no_twiddle(r, M):
    xr, xi = planes(r * M, (1, r * M))
    got = cplx(*stage_fused.fused_stage(tt(xr), tt(xi), r, twiddle=False))
    want = cplx(*jx_sf.fused_stage(jnp.asarray(xr), jnp.asarray(xi), r=r,
                                   twiddle=False, interpret=True))
    assert snr_db(got, want) >= 115.0
    assert snr_db(got, _stage_oracle(xr, xi, r, -1, False)) >= 115.0


PIPELINES = [(1 << 20, (64, 128, 128)), (1 << 17, (8, 128, 128)),
             (1 << 15, (2, 128, 128)),
             (1 << 15, stage_fused.pipeline_factors(1 << 15)),
             (1 << 17, stage_fused.pipeline_factors(1 << 17))]


@pytest.mark.parametrize("n,factors", PIPELINES, ids=[f"{n}-{f}" for n, f in PIPELINES])
def test_pipeline_matches_jax(n, factors):
    xr, xi = planes(n % 997, (1, n))
    got = cplx(*stage_fused.fft_split_pipeline(tt(xr), tt(xi), factors=factors))
    want = cplx(*jx_sf.fft_split_pipeline(jnp.asarray(xr), jnp.asarray(xi),
                                          factors=factors, interpret=True))
    assert snr_db(got, want) >= 115.0
    assert snr_db(got, oracle(xr, xi, -1)) >= 110.0


@pytest.fixture
def jax_pipeline_interpret(monkeypatch):
    """The JAX `pallas_pipeline` route with its kernel in interpret mode."""
    monkeypatch.setattr(jx_sf, "fft_split_pipeline",
                        functools.partial(jx_sf.fft_split_pipeline, interpret=True))


@pytest.mark.parametrize("n", [1 << 15, 1 << 17])
@pytest.mark.parametrize("direction,scale", [(-1, None), (1, None), (1, 0.5)])
def test_run_route_matches_jax_route(jax_pipeline_interpret, n, direction, scale):
    xr, xi = planes(n + direction, (2, n))
    got = cplx(*dispatch.run_route("stage_pipeline", tt(xr), tt(xi), direction,
                                   scale=scale))
    want = cplx(*jx_dispatch.run_route("pallas_pipeline", jnp.asarray(xr),
                                       jnp.asarray(xi), direction, scale=scale))
    assert snr_db(got, want) >= 115.0
    eff = (1.0 / n if direction == 1 else 1.0) * (scale or 1.0)
    assert snr_db(got, oracle(xr, xi, direction, eff)) >= 110.0


@pytest.mark.parametrize("e", range(8, 27))
def test_pipeline_factors_equal(e):
    n = 1 << e
    ours = stage_fused.pipeline_factors(n)
    assert ours == jx_sf.pipeline_factors(n)
    rem = n
    for r in ours[:-1]:
        assert (rem // r) % 128 == 0
        rem //= r


@pytest.mark.parametrize("n", [1000, 128, 3 << 10])
def test_pipeline_factors_refuse(n):
    with pytest.raises(ValueError, match="pow2 n"):
        stage_fused.pipeline_factors(n)


def test_pipeline_refuses_bad_factors():
    x = torch.zeros(1, 1 << 20)
    with pytest.raises(ValueError, match="reorder factors"):
        stage_fused.fft_split_pipeline(x, x, factors=(128, 128, 64))
    with pytest.raises(ValueError, match="multiply"):
        stage_fused.fft_split_pipeline(x, x, factors=(128, 128))


def test_fused_stage_refuses_columns_off_128():
    x = torch.zeros(1, 64 * 100)
    with pytest.raises(ValueError, match="M % 128"):
        stage_fused.fused_stage(x, x, 64)


def test_stage_kernel_refuses_cpu_tensors():
    x = torch.zeros(2, 2 * 128)
    with pytest.raises(ValueError, match="CUDA kernel"):
        stage_fused._launch(x, x, 2, stage_fused.Direction.FORWARD, True, 128)


@pytest.mark.parametrize("e", range(8, 27))
def test_stage_tiles_fit_the_kernel(e):
    """Every stage of every pipeline gets a tile of 4096 values with at
    least 32 columns (128 bytes contiguous per row and digit)."""
    n = 1 << e
    rem = n
    for r in stage_fused.pipeline_factors(n)[:-1]:
        T, G = stage_fused._stage_tile(r, rem // r)
        assert r * T * G == stage_fused.STAGE_TILE and (rem // r) % T == 0 and T >= 32
        rem //= r


def test_plan_from_jax_pipeline():
    for n in (1 << 20, 1 << 15):
        plan = api.plan_from_jax("pallas_pipeline", n, -1)
        assert plan.algorithm == "stage_pipeline" and plan.n == n
    xr, xi = planes(4, (2, 1 << 15))
    got = cplx(*plan.execute((tt(xr), tt(xi))))
    assert snr_db(got, oracle(xr, xi, -1)) >= 110.0
