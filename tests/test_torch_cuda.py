"""fftlab_torch's CUDA kernels on the card: each kernel against its plain
version and a float64 oracle, the launch counts of the main path, and
the wrappers' refusals. Every test here needs a CUDA card and skips
without one.

This file imports neither jax nor fftlab, so it runs where JAX is not
installed. On the machine with the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gates: kernel vs plain version >= 110 dB SNR; kernel vs the float64
oracle >= 120 dB (two-pass) or >= 110 dB (rows), the JAX suite's gates
(tests/test_resident_vmem.py:37, tests/test_kernels.py:39). The plain
versions run with TF32 off: TF32 matmuls would cost about 60 dB."""

import pytest
import torch

import fftlab_torch
from _torch_parity import (CASE_IDS, CASES, cplx, hide_nvcc, oracle, planes,
                           requires_cuda, snr_db, tt, whole_scale)
from fftlab_torch.kernels import _build, fft_vmem, fourstep_vmem
from fftlab_torch.plan import hardware

pytestmark = requires_cuda


def _cuda_pair(seed, shape):
    xr, xi = planes(seed, shape)
    return tt(xr, "cuda"), tt(xi, "cuda")


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_detect_hardware_gpu():
    caps = hardware.detect_hardware()
    assert caps.platform == "gpu"
    assert caps.device_name == torch.cuda.get_device_name(0)
    assert caps.sm_count > 0 and caps.smem_per_block_bytes >= 128 * 1024
    assert caps.l2_bytes > 0


@pytest.mark.parametrize("n", [1024, 8192, 16384])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_fft_rows_matches_plain(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n, (8, n))
    eff = whole_scale(n, direction, scale)
    before = fft_vmem.LAUNCHES["fft_rows"]
    got = cplx(*fft_vmem.fft_rows(xr, xi, direction, eff))
    assert fft_vmem.LAUNCHES["fft_rows"] == before + 1
    plain = cplx(*fft_vmem.fft_rows_plain(xr, xi, direction, eff))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 110.0


@pytest.mark.parametrize("n", [1 << 15, 1 << 18, 1 << 21])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_two_pass_matches_plain(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n % 97, (2, n))
    eff = whole_scale(n, direction, scale)
    mid = fourstep_vmem.fourstep_pass1(xr, xi, direction)
    mid_plain = fourstep_vmem.fourstep_pass1_plain(xr, xi, direction)
    assert snr_db(cplx(*mid), cplx(*mid_plain)) >= 110.0
    got = cplx(*fourstep_vmem.fourstep_pass2(*mid, direction, eff))
    plain = cplx(*fourstep_vmem.fourstep_pass2_plain(*mid, direction, eff))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0


@pytest.mark.parametrize("n,route,kernels", [
    (16384, "smem_rows", ("fft_rows",)),
    (1 << 20, "two_pass", ("fourstep_pass1", "fourstep_pass2"))])
def test_slice_launches_kernels(n, route, kernels):
    xr, xi = planes(n, (4, n))
    before = {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES}
    plan = fftlab_torch.plan_dft_1d_split(n, batch=4)
    yr, yi = plan.execute((tt(xr, "cuda"), tt(xi, "cuda")))
    after = {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES}
    assert plan.algorithm == route and yr.device.type == "cuda"
    for k in kernels:
        assert after[k] == before[k] + 1
    gate = 110.0 if route == "smem_rows" else 120.0
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= gate


def test_wrappers_refuse_without_casting():
    x64 = torch.zeros(2, 1 << 15, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fourstep_vmem.fft_split_large(x64, x64)
    xt = torch.zeros(1 << 15, 2, device="cuda").T  # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fourstep_vmem.fourstep_pass1(xt, xt)
    with pytest.raises(ValueError, match="contiguous"):
        fft_vmem.fft_rows(xt[:, :8192], xt[:, :8192])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With nvcc hidden, a fresh build raises instead of falling back."""
    hide_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.compile_library(tmp_path / _build.LIB_NAME)
