"""fftlab_torch kernel modules: the owned tables, each kernel's plain
version against the JAX kernel (Pallas interpret mode, as the JAX suite
runs it on the CPU) or, above the small end of each window, against
fftlab.algos.split_stockham.fft_split; the wrappers' refusals; and the
nvcc build. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Gates: port vs the float64 numpy oracle >= 120 dB SNR (>= 110 dB for the
row kernel); port vs JAX >= 110 dB. Both sides are float32 with
different summation orders; the gates are the JAX suite's own
(tests/test_resident_vmem.py:37, tests/test_kernels.py:39). The owned
tables must equal the JAX package's exactly."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.kernels.fft_vmem as jx_rows
import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.resident_vmem as jx_res
from _torch_parity import (CASE_IDS, CASES, cplx, hide_nvcc, oracle, planes,
                           snr_db, tt, whole_scale)
from fftlab.algos.split_stockham import fft_split as jx_fft_split
from fftlab_torch.kernels import (_build, fft_vmem, fourstep_vmem, os_filter_vmem,
                                  resident_vmem)

# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("L", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("scale", [None, 0.5, 1.0 / 2048])
def test_col_fft_tables_equal(L, direction, scale):
    ours = fourstep_vmem._col_fft_tables(L, direction, scale)
    theirs = jx_fs._col_fft_tables(L, direction, scale)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("L1,L2,W", [(128, 256, 16), (128, 256, 128),
                                     (1024, 1024, 16), (1024, 2048, 128),
                                     (1024, 2048, 16)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_rank1_twiddle_equal(L1, L2, W, direction):
    A, P = fourstep_vmem._rank1_twiddle_np(L1, L2, W, direction)
    jA, jP = jx_fs._rank1_twiddle_np(L1, L2, W, direction)
    assert np.array_equal(A, jA) and np.array_equal(P, jP)


@pytest.mark.parametrize("n", [1024, 8192, 16384])
@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("scale", [None, 0.5])
def test_rows_tables_equal(n, direction, scale):
    ours = fft_vmem._tables(n, direction, scale)
    theirs = jx_rows._tables(n, direction, np.float32, scale)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_sides_and_windows_equal():
    for e in range(15, 22):
        n = 1 << e
        assert fourstep_vmem._split_sides(n) == jx_fs._split_sides(n)
    for L in (128, 256, 1024, 2048):
        assert fourstep_vmem._split_factors(L) == jx_fs._split_factors(L)
    for n in [512, 1000, 1024, 1536, 4096, 8192, 16384, 1 << 15, 1 << 20,
              1 << 21, 1 << 22, 3 << 15]:
        assert fft_vmem.supported_size(n) == jx_rows.supported_size(n)
        assert fourstep_vmem.supported_large(n) == jx_fs.supported_large(n)
        assert resident_vmem.supported_resident(n) == jx_res.supported_resident(n)


# ------------------------------------------------- plain versions vs JAX


@pytest.mark.parametrize("n", [1024, 8192, 16384])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_rows_plain_matches_pallas(n, direction, scale):
    xr, xi = planes(n, (2, n))
    got = cplx(*fft_vmem.fft_split_rows(tt(xr), tt(xi), direction, scale=scale))
    want = cplx(*jx_rows.pallas_fft_split(
        jnp.asarray(xr), jnp.asarray(xi), direction, interpret=True,
        scale=scale))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, direction,
                              whole_scale(n, direction, scale))) >= 110.0


@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_resident_plain_matches_pallas_v6(direction, scale):
    n = 1 << 15
    xr, xi = planes(7, (2, n))
    got = cplx(*resident_vmem.fft_split_resident(tt(xr), tt(xi), direction, scale=scale))
    want = cplx(*jx_res.fft_split_resident(
        jnp.asarray(xr), jnp.asarray(xi), direction, interpret=True,
        scale=scale, layout="v6"))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, direction,
                              whole_scale(n, direction, scale))) >= 120.0


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_two_pass_plain_matches_pallas(n, direction, scale):
    xr, xi = planes(n + 3, (2, n))
    got = cplx(*fourstep_vmem.fft_split_large(tt(xr), tt(xi), direction, scale=scale))
    want = cplx(*jx_fs.fft_split_large(
        jnp.asarray(xr), jnp.asarray(xi), direction, interpret=True,
        scale=scale))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, direction,
                              whole_scale(n, direction, scale))) >= 120.0


@pytest.mark.parametrize("n", [1 << 20, 1 << 21])
@pytest.mark.parametrize("direction", [-1, 1])
def test_two_pass_plain_large_matches_fft_split(n, direction):
    xr, xi = planes(n % 101, (1, n))
    got = cplx(*fourstep_vmem.fft_split_large(tt(xr), tt(xi), direction))
    want = cplx(*jx_fft_split(jnp.asarray(xr), jnp.asarray(xi), direction))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, direction,
                              whole_scale(n, direction, None))) >= 120.0


def test_passes_compose_to_natural_order():
    """Pass 1 gives the twiddled column FFTs in row-major (L1, L2), and
    pass 2 turns them into the natural-order DFT; an order bug would show
    as a permuted spectrum on this random input."""
    n = 1 << 15
    L1, L2 = fourstep_vmem._split_sides(n)
    xr, xi = planes(11, (3, n))
    mr, mi = fourstep_vmem.fourstep_pass1_plain(tt(xr), tt(xi), -1)
    yr, yi = fourstep_vmem.fourstep_pass2_plain(mr, mi, -1, 1.0)
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 120.0
    # the intermediate is W_n^{k1*j2} * FFT_L1 over j1, row-major (L1, L2)
    x3 = (xr + 1j * xi.astype(np.float64)).reshape(3, L1, L2)
    k1 = np.arange(L1)[:, None]
    j2 = np.arange(L2)[None, :]
    mid = np.fft.fft(x3, axis=1) * np.exp(-2j * np.pi * k1 * j2 / n)
    assert snr_db(cplx(mr, mi).reshape(3, L1, L2), mid) >= 120.0


def test_batch_dims_kept():
    xr, xi = planes(5, (2, 3, 8192))
    yr, yi = fft_vmem.fft_split_rows(tt(xr), tt(xi))
    assert yr.shape == (2, 3, 8192) and yi.shape == (2, 3, 8192)
    xr, xi = planes(6, (2, 2, 1 << 15))
    yr, yi = fourstep_vmem.fft_split_large(tt(xr), tt(xi))
    assert yr.shape == (2, 2, 1 << 15)
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 120.0


# --------------------------------------------------------- refusals


@pytest.mark.parametrize("fn,n", [(fft_vmem.fft_split_rows, 8192),
                                  (fourstep_vmem.fft_split_large, 1 << 15),
                                  (resident_vmem.fft_split_resident, 1 << 15)])
def test_wrappers_refuse_other_dtypes(fn, n):
    x = torch.zeros(2, n, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        fn(x, x)
    with pytest.raises(ValueError, match="shape mismatch"):
        fn(torch.zeros(2, n), torch.zeros(3, n))


@pytest.mark.parametrize("fn,n", [(fft_vmem.fft_split_rows, 4096 + 128),
                                  (fft_vmem.fft_split_rows, 32768),
                                  (fourstep_vmem.fft_split_large, 1 << 14),
                                  (fourstep_vmem.fft_split_large, 1 << 22),
                                  (resident_vmem.fft_split_resident, 1 << 21)])
def test_wrappers_refuse_sizes_outside_window(fn, n):
    with pytest.raises(ValueError, match="supports"):
        fn(torch.zeros(1, n), torch.zeros(1, n))


def _all_launches():
    return {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES, **os_filter_vmem.LAUNCHES}


@pytest.mark.parametrize("launch", [
    lambda x: fft_vmem.fft_rows(x, x),
    lambda x: fourstep_vmem.fourstep_pass1(x, x),
    lambda x: fourstep_vmem.fourstep_pass2(x, x),
    lambda x: fourstep_vmem.fourstep_pass2_sandwich(x, x, x[0], x[0]),
    lambda x: fft_vmem.filter_rows(x[:, :8192], x[:, :8192], x[0, :8192], x[0, :8192]),
    lambda x: os_filter_vmem.os_filter(x, x, x[0, :2048], x[0, :2048], 9),
], ids=["fft_rows", "fourstep_pass1", "fourstep_pass2", "fourstep_pass2_sandwich",
        "filter_rows", "os_filter"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    a plain version in the kernel's name."""
    before = _all_launches()
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(2, 1 << 15))
    assert _all_launches() == before


def test_cpu_path_counts_no_launch():
    before = _all_launches()
    x = torch.zeros(1, 1 << 15)
    h = np.ones(1 << 15)
    fourstep_vmem.fft_split_large(x, x)
    fft_vmem.fft_split_rows(x[:, :8192], x[:, :8192])
    fourstep_vmem.spectral_filter_large(x, x, h, h)
    fft_vmem.pallas_spectral_filter(x[:, :8192], x[:, :8192], h[:8192], h[:8192])
    os_filter_vmem.pallas_os_filter_split(x, x, np.ones(9))
    assert _all_launches() == before


# ------------------------------------------------------------- the build


def _c_entries():
    """extern "C" int entries of csrc/*.cu with their parameter counts."""
    found = {}
    for path in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_ctypes_signatures_match_sources():
    assert _c_entries() == {k: len(v) for k, v in _build.SIGNATURES.items()}
    assert set(_build.SIGNATURES) == {
        "fftlab_fft_rows", "fftlab_fourstep_pass1", "fftlab_fourstep_pass1_no_twiddle",
        "fftlab_fourstep_pass2", "fftlab_fourstep_pass2_sandwich", "fftlab_filter_rows",
        "fftlab_os_filter",
        "fftlab_fourstep_pass1_packed", "fftlab_fourstep_pass2_interleaved",
        "fftlab_fourstep_pass2_unpack", "fftlab_pack_real", "fftlab_interleave", "fftlab_herm_unpack",
        "fftlab_herm_repack", "fftlab_stft_frames", "fftlab_fourstep_pass1_swap",
        "fftlab_fused_stage", "fftlab_stage_leaf"}
    for args in _build.SIGNATURES.values():
        assert args[-1] is ctypes.c_void_p  # the stream


def test_pointer_arguments_are_void_p():
    """Every pointer parameter in the C entries is declared c_void_p, so
    ctypes never cuts it to 32 bits."""
    for path in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            for p, t in zip(params.split(","), _build.SIGNATURES[name]):
                if "*" in p:
                    assert t is ctypes.c_void_p, (name, p)


def test_nvcc_flags_target_sm90a():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build.source_digest()) == 16
    assert _build.source_digest() == _build.source_digest()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With nvcc hidden, a fresh build raises and does not fall back
    (tests/test_torch_cuda.py repeats this on the card)."""
    hide_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.compile_library(tmp_path / "out" / _build.LIB_NAME)
    assert not (tmp_path / "out" / _build.LIB_NAME).exists()


def test_build_reports_compiler_failure(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(fake)
    with pytest.raises(RuntimeError, match="exit code 2"):
        _build.compile_library(tmp_path / "out" / _build.LIB_NAME)
