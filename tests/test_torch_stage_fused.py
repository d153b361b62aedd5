"""fftlab_torch's fused radix stage and the stage pipeline
(kernels/stage_fused.py, the `stage_pipeline` route) against the JAX
package on the same float32 inputs: the plain `fused_stage` against the
JAX kernel in interpret mode, `fft_split_pipeline` and
`run_route("stage_pipeline")` against the JAX `fft_split_pipeline` and
`run_route("pallas_pipeline")` (its kernel in interpret mode: on the CPU
the JAX route compiles only so), the card's launch sequence (the stage,
the swap stages and the leaf pass, each by its plain version) against
both, and `pipeline_factors`. The launch geometry of every stage and
leaf, and numpy models of the two kernels' index math (blocks, masks,
the swap store, the leaf's natural-order store), are checked here; the
CUDA kernels run on the card in tests/test_torch_cuda.py.

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
from fftlab_torch.kernels import _common, fourstep_vmem, stage_fused
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


MAX_SMEM = 232448  # a block's shared memory on the H100
INT_MAX = 2**31 - 1


@pytest.mark.parametrize("e", range(8, 27))
def test_stage_tiles_fit_the_kernel(e):
    """Every stage and the leaf of every pipeline get the launch that
    csrc/fourstep.cu checks and runs (`fftlab_fused_stage`,
    `fftlab_stage_leaf`): a stage's block 4096 values in 256 threads, G =
    256/r rows of 16 columns (one entry of the rank-1 factor A per k1), a
    padded tile with every element at its own place from r = 32 and no
    shared memory below; the leaf's block R = 4096/leaf rows (32 at 128),
    at least 8, in pass 2's tile; the grids within INT_MAX at a batch of
    16."""
    n = 1 << e
    factors = stage_fused.pipeline_factors(n)
    rem, f1 = n, 1
    for r in factors[:-1]:
        M = rem // r
        geo = fourstep_vmem.stage_geometry(r)
        G = geo.T // 16
        assert geo.threads == 256 and geo.T * r == 4096 and G * 16 == geo.T and G >= 2
        assert geo.schedule == _common.radix_schedule(r) and geo.log_pad == 4
        assert M % 16 == 0 and (M // 16) * -(-16 * f1 // G) <= INT_MAX
        if r <= 16:
            assert geo.smem == 0
        else:
            t, el = np.arange(geo.T)[:, None], np.arange(r)[None, :]
            at = t * geo.stride + el + (el >> 4)
            assert len(np.unique(at)) == geo.T * r and at.max() < geo.T * geo.stride
            assert geo.smem == 8 * geo.T * geo.stride <= MAX_SMEM // 4  # four blocks an SM
        f1 *= r
        rem = M
    leaf = fourstep_vmem.leaf_geometry(factors[-1])
    assert factors[-1] == 128 and leaf.T == 32 and leaf.threads == 256
    assert leaf.smem == 8 * leaf.T * leaf.stride <= MAX_SMEM // 4
    assert -(-16 * (n // 128) // leaf.T) <= INT_MAX


def _stage_model(x, r, f1, direction):
    """csrc/fourstep.cu `stage_tile`'s index math in float64 numpy: block
    `blk` and transform t load row b0 + t/16, column j2_0 + t%16 (zeros
    past the batch), run the length-r DFT down it, multiply W^{k*j2} and
    store output k at row (o, k, k1a) of b = o*F1 + k1a. Every output
    place is written exactly once."""
    rows, n = x.shape
    M = n // r
    T = fourstep_vmem.stage_geometry(r).T
    G, C = T // 16, M // 16
    blk = np.arange(-(-rows // G) * C)[:, None]
    t = np.arange(T)[None, :]
    b = (blk // C) * G + t // 16
    j2 = (blk % C) * 16 + t % 16
    ok = b < rows
    cols = np.where(ok[..., None], x.reshape(rows, r, M)[np.minimum(b, rows - 1), :, j2], 0)
    k = np.arange(r)
    F = np.exp(2j * np.pi * direction * np.outer(k, k) / r)
    y = cols @ F.T * np.exp(2j * np.pi * direction * j2[..., None] * k / n)
    row = (b & ~(f1 - 1))[..., None] * r + k * f1 + (b & (f1 - 1))[..., None]
    at = (row * M + j2[..., None])[ok]
    out = np.zeros(rows * n, complex)
    out[at.ravel()] = y[ok].ravel()
    assert len(np.unique(at)) == rows * n
    return out.reshape(rows, n)


def _leaf_model(x, leaf, direction, scale):
    """csrc/fourstep.cu `leaf_tile`'s index math in float64 numpy: block
    `blk` and row r take row q = blk*R + r of the batch*L1 rows (zeros past
    the end), run the length-leaf DFT along it and store element k2 at
    k2*L1 + k1 of batch row b, q = b*L1 + k1."""
    B, n = x.shape
    L1 = n // leaf
    R = fourstep_vmem.leaf_geometry(leaf).T
    q = np.arange(-(-B * L1 // R))[:, None] * R + np.arange(R)[None, :]
    ok = q < B * L1
    rows = np.where(ok[..., None], x.reshape(B * L1, leaf)[np.minimum(q, B * L1 - 1)], 0)
    y = (np.fft.fft(rows, axis=-1) if direction == -1 else np.fft.ifft(rows, axis=-1) * leaf)
    k2 = np.arange(leaf)
    at = (((q // L1) * n + q % L1)[..., None] + k2 * L1)[ok]
    out = np.zeros(B * n, complex)
    out[at.ravel()] = (y * scale)[ok].ravel()
    assert len(np.unique(at)) == B * n
    return out.reshape(B, n)


@pytest.mark.parametrize("r", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("f1", [1, 4])
def test_stage_kernel_layout_model(r, f1):
    """The stage kernel's blocks, masks and swap store (a numpy model of
    `stage_tile`, three batch rows per F1: the last block half empty)
    against the plain version the card holds it to."""
    M = 256 if r < 64 else 128
    xr, xi = planes(r * f1, (3 * f1, r * M))
    x = xr + 1j * xi.astype(np.float64)
    got = _stage_model(x, r, f1, -1)
    plain = cplx(*(stage_fused.fused_stage_plain(tt(xr), tt(xi), r) if f1 == 1
                   else stage_fused.swap_stage_plain(tt(xr), tt(xi), r, f1)))
    assert snr_db(plain, got) >= 115.0


@pytest.mark.parametrize("B,n,leaf", [(3, 256, 128), (1, 512, 128), (2, 1 << 15, 128),
                                      (3, 1 << 12, 256), (1, 1 << 13, 1024), (5, 128, 128)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_leaf_kernel_layout_model(B, n, leaf, direction):
    """The leaf kernel's rows of several batch rows a block and its store
    in natural order (a numpy model of `leaf_tile`) against its plain
    version."""
    xr, xi = planes(n + B, (B, n))
    scale = 0.5 / n if direction == 1 else 1.0
    got = _leaf_model(xr + 1j * xi.astype(np.float64), leaf, direction, scale)
    plain = cplx(*stage_fused.stage_leaf_plain(tt(xr), tt(xi), leaf, direction, scale))
    assert snr_db(plain, got) >= 115.0


# the card's launch sequence: every pipeline from 2^8 to 2^17 and the
# JAX suite's own factor sets (tests/test_stage_fused.py)
SEQUENCES = ([(1 << e, stage_fused.pipeline_factors(1 << e)) for e in range(8, 18)]
             + [(1 << 20, (64, 128, 128)), (1 << 17, (8, 128, 128)), (1 << 15, (2, 128, 128))])


@functools.lru_cache(maxsize=None)
def _jax_pipeline(n, factors, direction):
    xr, xi = planes(n % 991 + direction, (2, n))
    want = cplx(*jx_sf.fft_split_pipeline(jnp.asarray(xr), jnp.asarray(xi), direction,
                                          factors=factors, interpret=True))
    return xr, xi, want


@pytest.mark.parametrize("n,factors", SEQUENCES, ids=[f"{n}-{f}" for n, f in SEQUENCES])
@pytest.mark.parametrize("direction,scale", [(-1, None), (1, None), (1, 0.5)],
                         ids=["fwd", "inv", "inv_scale"])
def test_launch_sequence_matches_jax(n, factors, direction, scale):
    """The launches the card makes (the stage, the swap stages, the leaf
    pass), each by its plain version, against the JAX route with its
    kernel in interpret mode and against float64."""
    xr, xi, want = _jax_pipeline(n, factors, direction)
    got = cplx(*stage_fused.pipeline_launches_plain(tt(xr), tt(xi), direction, factors, scale))
    assert snr_db(got, want * (scale or 1.0)) >= 115.0
    eff = (1.0 / n if direction == 1 else 1.0) * (scale or 1.0)
    assert snr_db(got, oracle(xr, xi, direction, eff)) >= 110.0


def test_plan_from_jax_pipeline():
    for n in (1 << 20, 1 << 15):
        plan = api.plan_from_jax("pallas_pipeline", n, -1)
        assert plan.algorithm == "stage_pipeline" and plan.n == n
    xr, xi = planes(4, (2, 1 << 15))
    got = cplx(*plan.execute((tt(xr), tt(xi))))
    assert snr_db(got, oracle(xr, xi, -1)) >= 110.0
