"""The port's tensor-op contractions run at full float32 whatever matmul
precision the caller set (fftlab_torch/core/precision.py), as the JAX
package pins `Precision.HIGHEST` (fftlab/algos/split_stockham.py), and
the caller's setting is back when the call returns.

At "medium" PyTorch runs float32 matmuls in bfloat16 where it can, on
the CPU too: the einsum route at (4, 1000) then read 51.3 dB against
float64. Gates: >= 120 dB against float64 and against the JAX function
(the JAX suite's c2c gate, tests/test_resident_vmem.py:37); the plain
row kernel's own gate is 110 dB (tests/test_kernels.py:39) and the stage
pipeline's 115 dB (tests/test_stage_fused.py:31). The inputs are float32
on both sides (jax x64 is on, tests/conftest.py)."""

import concurrent.futures
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab.algos import split_stockham as jx
from fftlab_torch.algos import split_stockham as pt
from fftlab_torch.core.precision import full_float32
from fftlab_torch.kernels import fft_vmem, fourstep_vmem, stage_fused, threestep_vmem


@pytest.fixture
def medium():
    """The caller's precision at "medium"; the default after the test."""
    torch.set_float32_matmul_precision("medium")
    yield
    torch.set_float32_matmul_precision("highest")


def test_einsum_route_at_medium(medium):
    xr, xi = planes(0, (4, 1000))
    got = cplx(*pt.fft_split(tt(xr), tt(xi)))
    assert torch.get_float32_matmul_precision() == "medium"
    want = cplx(*jx.fft_split(jnp.asarray(xr), jnp.asarray(xi)))
    assert snr_db(got, oracle(xr, xi, -1)) >= 120.0
    assert snr_db(got, want) >= 120.0


def test_sandwich_at_medium(medium):
    n = 1000
    xr, xi = planes(1, (4, n))
    hr, hi = planes(2, (n,))
    got = cplx(*pt.spectral_filter_split_fused(tt(xr), tt(xi), hr, hi))
    assert torch.get_float32_matmul_precision() == "medium"
    want = cplx(*jx.spectral_filter_split_fused(jnp.asarray(xr), jnp.asarray(xi),
                                                jnp.asarray(hr), jnp.asarray(hi)))
    z = xr + 1j * xi.astype(np.float64)
    h = hr + 1j * hi.astype(np.float64)
    assert snr_db(got, np.fft.ifft(np.fft.fft(z) * h)) >= 120.0
    assert snr_db(got, want) >= 120.0


PLAIN = {
    "rows": (lambda a, b: fft_vmem.fft_rows_plain(a, b), 8192, 110.0),
    "two_pass": (lambda a, b: fourstep_vmem.fft_split_large(a, b), 1 << 15, 120.0),
    "stage_pipeline": (lambda a, b: stage_fused.fft_split_pipeline_plain(
        a, b, -1, stage_fused.pipeline_factors(1 << 15)), 1 << 15, 115.0),
    "three_pass": (lambda a, b: threestep_vmem.fft_split_huge_plain(a, b), 1 << 21, 120.0),
}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_versions_at_medium(medium, name):
    """The kernels' plain versions (their matmuls) at "medium"."""
    fn, n, gate = PLAIN[name]
    xr, xi = planes(n % 97, (2, n))
    got = cplx(*fn(tt(xr), tt(xi)))
    assert snr_db(got, oracle(xr, xi, -1)) >= gate


@pytest.mark.parametrize("setting", ["medium", "high", "highest"])
def test_caller_setting_restored(setting):
    torch.set_float32_matmul_precision(setting)
    try:
        xr, xi = planes(3, (2, 1000))
        pt.fft_split(tt(xr), tt(xi))
        assert torch.get_float32_matmul_precision() == setting
        assert torch.backends.cuda.matmul.allow_tf32 == (setting != "highest")
        with full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision("highest")


def test_restored_after_mixed_settings():
    """After "medium" and then `allow_tf32 = True` this PyTorch refuses to
    read the legacy setting back (the two APIs disagree); the helper then
    keeps and restores the per-backend settings instead."""
    backends = (torch.backends, torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    torch.set_float32_matmul_precision("medium")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        before = [b.fp32_precision for b in backends]
        xr, xi = planes(0, (4, 1000))
        got = cplx(*pt.fft_split(tt(xr), tt(xi)))
        assert snr_db(got, oracle(xr, xi, -1)) >= 120.0
        assert [b.fp32_precision for b in backends] == before
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"


def test_restored_after_concurrent_calls(medium):
    """Eight threads run `fft_split` at once, their blocks interleaving
    (a barrier starts each round together): every result holds the gate,
    and the caller's "medium" is back when all have returned."""
    threads, rounds = 8, 4
    barrier = threading.Barrier(threads)
    inputs = [planes(10 + i, (4, 1000)) for i in range(threads)]

    def worker(i):
        xr, xi = inputs[i]
        worst = np.inf
        for _ in range(rounds):
            barrier.wait()
            got = cplx(*pt.fft_split(tt(xr), tt(xi)))
            worst = min(worst, snr_db(got, oracle(xr, xi, -1)))
        return worst

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        worst = list(pool.map(worker, range(threads)))
    assert min(worst) >= 120.0
    assert torch.get_float32_matmul_precision() == "medium"
    assert torch.backends.cuda.matmul.allow_tf32


def test_restored_after_an_error(medium):
    with pytest.raises(RuntimeError, match="inside"):
        with full_float32():
            raise RuntimeError("inside")
    assert torch.get_float32_matmul_precision() == "medium"


# the complex path: every registry algorithm that contracts with a DFT
# matrix (the naive and optimized DFT, radix-4, the codelet matmul of mixed radix
# at primes >= 7, Stockham, four-step), the public one-shot calls, the
# real and 2-D transforms. This CPU has no bfloat16 path for a complex
# matmul, so here these hold with or without full_float32; on the card
# CGEMM takes TF32 (test_complex_api_at_high_precision in
# tests/test_torch_cuda.py)
COMPLEX = [("naive_dft", 256), ("optimized_dft", 256), ("radix4", 1024),
           ("mixed_radix", 7 * 11 * 13), ("stockham_mxu", 1000), ("stockham_mxu", 4096),
           ("four_step", 1000)]


@pytest.mark.parametrize("name,n", COMPLEX, ids=[f"{a}-{n}" for a, n in COMPLEX])
def test_complex_registry_at_medium(medium, name, n):
    from fftlab_torch.algos import build_registry

    xr, xi = planes(n, (4, n))
    x = torch.complex(tt(xr), tt(xi))
    got = build_registry()[name].fn(x).numpy()
    assert torch.get_float32_matmul_precision() == "medium"
    assert snr_db(got, oracle(xr, xi, -1)) >= 120.0


def test_complex_api_at_medium(medium):
    import fftlab_torch

    xr, xi = planes(5, (4, 1000))
    x = torch.complex(tt(xr), tt(xi))
    y = fftlab_torch.fft(x)
    assert snr_db(y.numpy(), oracle(xr, xi, -1)) >= 120.0
    assert snr_db(fftlab_torch.ifft(y).numpy(), xr + 1j * xi.astype(np.float64)) >= 120.0
    z = fftlab_torch.fft2(x)
    assert snr_db(z.numpy(), np.fft.fft2(xr + 1j * xi.astype(np.float64))) >= 120.0
    X = fftlab_torch.rfft(tt(xr))
    assert snr_db(X.numpy(), np.fft.rfft(xr.astype(np.float64))) >= 120.0
    assert snr_db(fftlab_torch.irfft(X, 1000).numpy(), xr.astype(np.float64)) >= 120.0
    assert torch.get_float32_matmul_precision() == "medium"


# ------------------------------------------------------------ convolutions
# cuDNN runs a float32 conv1d in TF32 while `torch.backends.cudnn.allow_tf32`
# is True (PyTorch's default), and this CPU's oneDNN in bfloat16 after
# `torch.backends.mkldnn.conv.fp32_precision = "bf16"`: there
# direct_convolution read 52 dB against float64. full_float32 turns both
# to full float32 for the block and gives the caller's settings back.

def _conv_settings():
    """Every conv setting a caller can see: the legacy cuDNN flag (None
    where PyTorch refuses to read it) and the per-backend strings."""
    try:
        legacy = torch.backends.cudnn.allow_tf32
    except RuntimeError:
        legacy = None
    return (legacy, torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cudnn.rnn.fp32_precision,
            torch.backends.mkldnn.conv.fp32_precision)


@pytest.fixture
def conv_caller():
    """The caller's conv settings at cuDNN TF32 on and oneDNN bf16;
    PyTorch's defaults after the test."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.mkldnn.conv.fp32_precision = "bf16"
    yield _conv_settings()
    torch.backends.mkldnn.conv.fp32_precision = "none"
    torch.backends.cudnn.allow_tf32 = True


def test_full_float32_turns_conv_tf32_off(conv_caller):
    with full_float32():
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        assert torch.backends.mkldnn.conv.fp32_precision == "ieee"
    assert _conv_settings() == conv_caller


def test_conv_settings_restored_after_an_error(conv_caller):
    with pytest.raises(RuntimeError, match="inside"):
        with full_float32():
            raise RuntimeError("inside")
    assert _conv_settings() == conv_caller


@pytest.mark.parametrize("caller", ["legacy_off", "per_backend"])
def test_conv_settings_restored_for_every_caller(caller):
    """A caller with TF32 off through the legacy flag, and one who set the
    per-backend strings (the legacy flag then refuses to be read)."""
    try:
        if caller == "legacy_off":
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.backends.cudnn.conv.fp32_precision = "tf32"
            torch.backends.cudnn.rnn.fp32_precision = "ieee"
        before = _conv_settings()
        with full_float32():
            assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        assert _conv_settings() == before
    finally:
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        torch.backends.cudnn.rnn.fp32_precision = "tf32"
        torch.backends.cudnn.allow_tf32 = True


def _direct_snr(seed: int) -> float:
    from fftlab_torch.dsp.convolution import direct_convolution

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    h = rng.standard_normal(129).astype(np.float32)
    got = direct_convolution(x, h, device="cpu").numpy()
    want = np.stack([np.convolve(r.astype(np.float64), h.astype(np.float64)) for r in x])
    return snr_db(got, want)


@pytest.mark.parametrize("setting", ["medium", "oneDNN bf16"])
def test_direct_convolution_at_low_precision(medium, conv_caller, setting):
    """direct_convolution (one conv1d) at "medium", and with the caller's
    oneDNN conv in bfloat16, stays >= 110 dB against float64."""
    if setting == "medium":
        torch.backends.mkldnn.conv.fp32_precision = "none"
    assert _direct_snr(0) >= 110.0
    assert torch.get_float32_matmul_precision() == "medium"
    assert torch.backends.mkldnn.conv.fp32_precision == (
        "none" if setting == "medium" else "bf16")


def test_conv_settings_restored_after_concurrent_calls(medium, conv_caller):
    """Eight threads run direct_convolution at once, their blocks
    interleaving: each holds the gate, and the caller's conv settings are
    back when all have returned."""
    threads, rounds = 8, 3
    barrier = threading.Barrier(threads)

    def worker(i):
        worst = np.inf
        for _ in range(rounds):
            barrier.wait()
            worst = min(worst, _direct_snr(20 + i))
        return worst

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        worst = list(pool.map(worker, range(threads)))
    assert min(worst) >= 110.0
    assert _conv_settings() == conv_caller
    assert torch.get_float32_matmul_precision() == "medium"
