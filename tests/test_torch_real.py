"""fftlab_torch's real-signal path: the K7 counterparts (pack, interleave,
Hermitian unpack and repack), the fused K6 counterparts
(`rfft_resident`, `irfft_resident`), `rfft_split`/`irfft_split`, the
large-signal wrappers and the r2c/c2r plans, each against the JAX
package on the same float32 inputs: the JAX kernels in interpret mode at
the JAX suite's sizes (tests/test_rfft_resident.py:32,
tests/test_kernels.py:236-272), JAX's CPU path above them. The CUDA
kernels are tested on the card by tests/test_torch_cuda.py.

Gates: >= 110 dB SNR against the float64 numpy oracle and >= 110 dB
port vs JAX (float32 on both sides, different summation orders); the
pack and interleave are bit-exact (a copy); prime lengths run Bluestein
and keep the JAX suite's Bluestein gate, 95 dB (tests/test_split.py:272).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.rfft_resident as jx_res
import fftlab.kernels.rfft_vmem as jx_rv
import fftlab.plan.api as jx_api
from _torch_parity import cplx, snr_db, tt
from fftlab.algos import split_stockham as jx
import fftlab_torch
from fftlab_torch.algos import split_stockham as pt
from fftlab_torch.kernels import (fft_vmem, fourstep_vmem, os_filter_vmem,
                                  rfft_resident, rfft_vmem, stft_vmem, threestep_vmem)
from fftlab_torch.plan import api
from fftlab_torch.plan.flags import Flags

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)
    monkeypatch.delenv("FFTLAB_RFFT_FUSED", raising=False)


def real(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def rfft_oracle(x) -> np.ndarray:
    return np.fft.rfft(np.asarray(x, np.float64), axis=-1)


def half_spectrum(x: np.ndarray):
    """Z = FFT of x[0::2] + i*x[1::2] in float64, as float32 planes."""
    Z = np.fft.fft(x[..., 0::2].astype(np.float64) + 1j * x[..., 1::2], axis=-1)
    return Z.real.astype(np.float32), Z.imag.astype(np.float32)


def spectrum_planes(x: np.ndarray):
    X = rfft_oracle(x)
    return X.real.astype(np.float32), X.imag.astype(np.float32)


# ------------------------------------------------------- K7 counterparts


@pytest.mark.parametrize("n", [2048, 8192])
def test_pack_interleave_match_pallas(n):
    x = real(n, (3, n))
    zr, zi = rfft_vmem.pallas_pack_real(tt(x))
    jr, ji = jx_rv.pallas_pack_real(x, interpret=True)
    assert np.array_equal(zr.numpy(), np.asarray(jr))
    assert np.array_equal(zi.numpy(), np.asarray(ji))
    back = rfft_vmem.pallas_interleave(zr, zi)
    assert back.shape == (3, n)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(back.numpy(), np.asarray(jx_rv.pallas_interleave(jr, ji,
                                                                           interpret=True)))


@pytest.mark.parametrize("n", [2048, 8192])
def test_hermitian_unpack_matches_pallas(n):
    x = real(n + 1, (2, n))
    Zr, Zi = half_spectrum(x)
    got = cplx(*rfft_vmem.pallas_hermitian_unpack(tt(Zr), tt(Zi), n))
    want = cplx(*jx_rv.pallas_hermitian_unpack(jnp.asarray(Zr), jnp.asarray(Zi), n,
                                               interpret=True))
    assert got.shape == want.shape == (2, n // 2 + 1)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, rfft_oracle(x)) >= 110.0
    assert np.all(got.imag[:, -1] == 0.0)  # Nyquist is real, appended
    np.testing.assert_allclose(got.imag[:, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("n", [2048, 8192, 1 << 16])
def test_paired_unpack_agrees_with_unpaired(n):
    """The kernel's paired form (split_stockham.py:214-242) and the plain
    version's unpaired form (rfft_vmem.py:217-223) agree to float32
    rounding: >= 120 dB, the same products grouped otherwise."""
    Zr, Zi = half_spectrum(real(n + 2, (2, n)))
    paired = cplx(*pt._unpack_paired(tt(Zr), tt(Zi), n))
    unpaired = cplx(*rfft_vmem.herm_unpack_plain(tt(Zr), tt(Zi), n))
    assert snr_db(paired, unpaired) >= 120.0


@pytest.mark.parametrize("n", [2048, 8192, 1 << 16])
def test_herm_repack_inverts_the_unpack(n):
    x = real(n + 3, (2, n))
    Zr, Zi = half_spectrum(x)
    Xr, Xi = spectrum_planes(x)
    got = cplx(*rfft_vmem.hermitian_repack(tt(Xr), tt(Xi), n))
    assert got.shape == (2, n // 2)
    assert snr_db(got, Zr + 1j * Zi.astype(np.float64)) >= 120.0


def test_k7_refusals():
    with pytest.raises(ValueError, match="n/2 % 1024"):
        rfft_vmem.pallas_pack_real(torch.zeros(1, 100))
    with pytest.raises(ValueError, match="m % 1024"):
        rfft_vmem.pallas_hermitian_unpack(torch.zeros(1, 512), torch.zeros(1, 512), 1024)
    with pytest.raises(ValueError, match="n must be 2"):
        rfft_vmem.pallas_hermitian_unpack(torch.zeros(1, 1024), torch.zeros(1, 1024), 4096)
    with pytest.raises(ValueError, match="bins"):
        rfft_vmem.hermitian_repack(torch.zeros(1, 1024), torch.zeros(1, 1024), 2048)


# ------------------------------------------------------- K6 counterparts


@pytest.mark.parametrize("scale", [None, 0.25])
def test_rfft_resident_plain_matches_pallas(scale):
    n = 1 << 16
    x = real(5, (2, n))
    got = cplx(*rfft_resident.rfft_resident(tt(x), scale=scale))
    want = cplx(*jx_res.rfft_resident(x, scale=scale, interpret=True))
    assert got.shape == want.shape == (2, n // 2 + 1)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, rfft_oracle(x) * (scale or 1.0)) >= 110.0


@pytest.mark.parametrize("scale", [None, 0.25])
def test_irfft_resident_plain_matches_pallas(scale):
    """The c2r applies 1/m = 2/n and nothing else: on an unscaled rfft it
    returns the signal (rfft_resident.py:516-523)."""
    n = 1 << 16
    x = real(6, (2, n))
    Xr, Xi = spectrum_planes(x)
    got = rfft_resident.irfft_resident(tt(Xr), tt(Xi), scale=scale).numpy()
    want = np.asarray(jx_res.irfft_resident(Xr, Xi, scale=scale, interpret=True))
    assert got.shape == want.shape == (2, n)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, x.astype(np.float64) * (scale or 1.0)) >= 110.0


def test_resident_round_trip_and_batch_shapes():
    x = real(7, (2, 3, 1 << 16))
    Xr, Xi = rfft_resident.rfft_resident(tt(x), scale=0.5)
    assert Xr.shape == (2, 3, (1 << 15) + 1)
    back = rfft_resident.irfft_resident(Xr, Xi, scale=2.0)
    assert back.shape == x.shape
    assert snr_db(back.numpy(), x.astype(np.float64)) >= 110.0


def test_resident_plain_is_the_launch_sequence():
    """The plain fused r2c is pass 1 of the packed views, pass 2 and the
    unpack; the plain c2r the repack, the inverse passes with 1/m and the
    interleave. Held against the pieces one by one."""
    n = 1 << 16
    x = tt(real(8, (2, n)))
    mr, mi = fourstep_vmem.fourstep_pass1_packed_plain(x)
    ref = fourstep_vmem.fourstep_pass1_plain(x[:, 0::2].contiguous(),
                                             x[:, 1::2].contiguous())
    assert snr_db(cplx(mr, mi), cplx(*ref)) >= 140.0
    Zr, Zi = half_spectrum(x.numpy())
    y = fourstep_vmem.fourstep_pass2_interleaved_plain(
        *fourstep_vmem.fourstep_pass1_plain(tt(Zr), tt(Zi), 1), 1, 2.0 / n)
    assert y.shape == (2, n)
    assert snr_db(y.numpy(), x.numpy().astype(np.float64)) >= 110.0


def test_resident_window_matches_jax():
    for n in [1 << 15, 1 << 16, 1 << 21, 1 << 22, 3 << 16, (1 << 16) + 2, 1001]:
        assert rfft_resident.supported_rfft_resident(n) == jx_res.supported_rfft_resident(n)
        assert rfft_vmem.pack_supported(n) == jx_rv.pack_supported(n)


def test_resident_refuses():
    with pytest.raises(ValueError, match="resident"):
        rfft_resident.rfft_resident(torch.zeros(1, 1 << 22))
    with pytest.raises(ValueError, match="resident"):
        rfft_resident.irfft_resident(torch.zeros(1, 1025), torch.zeros(1, 1025))


# ----------------------------------------------------- rfft_split routes

# n -> the branch of rfft_split it takes (split_stockham.py:169-256)
SPLIT_SIZES = {
    16: "paired tensor ops", 1000: "paired tensor ops (m even)",
    1002: "unpaired tensor ops (m odd)", 999: "odd: complex fft_split",
    8192: "pack -> cfft -> unpack", 1 << 16: "fused",
}


@pytest.mark.parametrize("n", list(SPLIT_SIZES), ids=list(SPLIT_SIZES.values()))
def test_rfft_split_matches_jax(n):
    x = real(n, (2, n))
    got = cplx(*pt.rfft_split(tt(x)))
    want = cplx(*jx.rfft_split(jnp.asarray(x)))
    assert got.shape == want.shape == (2, n // 2 + 1)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, rfft_oracle(x)) >= 110.0


@pytest.mark.parametrize("n", list(SPLIT_SIZES), ids=list(SPLIT_SIZES.values()))
def test_irfft_split_matches_jax(n):
    x = real(n + 1, (2, n))
    Xr, Xi = spectrum_planes(x)
    got = pt.irfft_split(tt(Xr), tt(Xi), n=n).numpy()
    want = np.asarray(jx.irfft_split(jnp.asarray(Xr), jnp.asarray(Xi), n=n))
    assert got.shape == want.shape == (2, n)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("n", [257, 10007, 2 * 257])
def test_real_split_prime_lengths(n):
    """A prime factor above the leaf runs Bluestein on both sides."""
    x = real(n, (2, n))
    got = cplx(*pt.rfft_split(tt(x)))
    assert snr_db(got, cplx(*jx.rfft_split(jnp.asarray(x)))) >= 95.0
    assert snr_db(got, rfft_oracle(x)) >= 95.0
    back = pt.irfft_split(*pt.rfft_split(tt(x)), n=n).numpy()
    assert snr_db(back, x.astype(np.float64)) >= 95.0


def test_fused_opt_out_and_cfft_override(monkeypatch):
    """FFTLAB_RFFT_FUSED=0 and a given cfft both leave the fused kernels
    for the pack -> cfft -> unpack pipeline (split_stockham.py:190-191)."""
    calls = []
    real_fused = rfft_resident.rfft_resident
    monkeypatch.setattr(rfft_resident, "rfft_resident",
                        lambda x: calls.append(1) or real_fused(x))
    n = 1 << 16
    x = tt(real(9, (2, n)))
    want = rfft_oracle(x.numpy())
    assert snr_db(cplx(*pt.rfft_split(x)), want) >= 110.0
    assert calls == [1]
    monkeypatch.setenv("FFTLAB_RFFT_FUSED", "0")
    assert snr_db(cplx(*pt.rfft_split(x)), want) >= 110.0
    monkeypatch.delenv("FFTLAB_RFFT_FUSED")
    got = pt.rfft_split(x, cfft=lambda a, b: fourstep_vmem.fft_split_large(a, b))
    assert snr_db(cplx(*got), want) >= 110.0
    assert calls == [1]


def test_split_large_matches_jax():
    n = 1 << 16
    x = real(10, (2, n))
    got = fourstep_vmem.rfft_split_large(tt(x))
    want = jx_fs.rfft_split_large(x, interpret=True)
    assert snr_db(cplx(*got), cplx(*want)) >= 110.0
    assert snr_db(cplx(*got), rfft_oracle(x)) >= 110.0
    back = fourstep_vmem.irfft_split_large(*got).numpy()
    assert snr_db(back, np.asarray(jx_fs.irfft_split_large(*want, interpret=True))) >= 110.0
    assert snr_db(back, x.astype(np.float64)) >= 110.0


def test_split_large_windows(monkeypatch):
    """n/2 in 2^15..2^21 runs the two-pass kernels, 2^22..2^26 the
    three-pass kernel, anything else raises."""
    monkeypatch.setattr(fourstep_vmem, "fft_split_large", lambda a, b, d: "two_pass")
    monkeypatch.setattr(threestep_vmem, "fft_split_huge", lambda a, b, d: "three_pass")
    for n, route in [(1 << 16, "two_pass"), (1 << 22, "two_pass"),
                     (1 << 23, "three_pass"), (1 << 27, "three_pass")]:
        assert fourstep_vmem._half_cfft("rfft_split_large", n, -1)(None, None) == route
    for n in [1 << 15, (1 << 16) + 4, 1 << 28]:
        with pytest.raises(ValueError, match="power of two"):
            fourstep_vmem.rfft_split_large(torch.zeros(1, n))
    with pytest.raises(ValueError, match="even n"):
        fourstep_vmem.irfft_split_large(torch.zeros(1, 9), torch.zeros(1, 9), n=17)


REFUSING = {
    "rfft_split": (lambda x: pt.rfft_split(x), 1 << 16),
    "irfft_split": (lambda x: pt.irfft_split(x, x), 1 << 16),
    "rfft_resident": (lambda x: rfft_resident.rfft_resident(x), 1 << 16),
    "irfft_resident": (lambda x: rfft_resident.irfft_resident(x, x), (1 << 15) + 1),
    "rfft_split_large": (lambda x: fourstep_vmem.rfft_split_large(x), 1 << 16),
    "r2c_plan": (lambda x: fftlab_torch.plan_r2c_1d_split(1 << 16).execute(x), 1 << 16),
    "c2r_plan": (lambda x: fftlab_torch.plan_c2r_1d_split(1 << 16).execute((x, x)),
                 (1 << 15) + 1),
}


@pytest.mark.parametrize("name", list(REFUSING))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_real_path_refuses_other_dtypes(name, dtype):
    """The JAX r2c/c2r cast any input to float32 (rfft_resident.py:526-527,
    :551); the port refuses it with a ValueError."""
    fn, n = REFUSING[name]
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(2, n, dtype=dtype))


# --------------------------------------------------------------- plans

R2C_PLANS = [(1 << 16, "rfft_resident"), (1 << 21, "rfft_resident"),
             (1 << 22, "rfft_split[two_pass]"), (1 << 23, "rfft_split[three_pass]"),
             (8192, "rfft_split[einsum]"), (16384, "rfft_split[smem_rows]"),
             (32768, "rfft_split[smem_rows]"),
             (999, "rfft_split[einsum]"), (2, "rfft_split[einsum]")]


@pytest.mark.parametrize("n,algorithm", R2C_PLANS)
def test_real_plan_algorithms(n, algorithm):
    r2c = fftlab_torch.plan_r2c_1d_split(n, batch=4)
    c2r = fftlab_torch.plan_c2r_1d_split(n, batch=4)
    assert (r2c.kind, r2c.n, r2c.algorithm) == ("r2c_split", n, algorithm)
    assert (c2r.kind, c2r.algorithm) == ("c2r_split", "i" + algorithm)
    assert r2c.direction == fftlab_torch.FORWARD and c2r.direction == fftlab_torch.INVERSE


def test_fused_opt_out_in_plans(monkeypatch):
    monkeypatch.setenv("FFTLAB_RFFT_FUSED", "0")
    assert fftlab_torch.plan_r2c_1d_split(1 << 16).algorithm == "rfft_split[two_pass]"
    assert fftlab_torch.plan_c2r_1d_split(1 << 16).algorithm == "irfft_split[two_pass]"


@pytest.mark.parametrize("n", [8192, 32768, 1 << 16, 1 << 17, 1000])
def test_real_plans_match_jax(n):
    x = real(n + 5, (2, n))
    r2c = fftlab_torch.plan_r2c_1d_split(n, batch=2)
    c2r = fftlab_torch.plan_c2r_1d_split(n, batch=2)
    Xr, Xi = r2c.execute(tt(x))
    jr, ji = jx_api.plan_r2c_1d_split(n).execute(jnp.asarray(x))
    assert snr_db(cplx(Xr, Xi), cplx(jr, ji)) >= 110.0
    assert snr_db(cplx(Xr, Xi), rfft_oracle(x)) >= 110.0
    y = c2r.execute((Xr, Xi)).numpy()
    jy = np.asarray(jx_api.plan_c2r_1d_split(n).execute((jr, ji)))
    assert snr_db(y, jy) >= 110.0
    assert snr_db(y, x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("flag", [Flags.MEASURE, Flags.WISDOM_ONLY])
def test_real_plans_measuring_flags_not_ported(flag):
    for make in (fftlab_torch.plan_r2c_1d_split, fftlab_torch.plan_c2r_1d_split):
        with pytest.raises(NotImplementedError, match="half-size"):
            make(1 << 16, flags=flag)


@pytest.mark.parametrize("kind,algorithm,n,want", [
    ("r2c_split", "rfft_resident", 1 << 16, "rfft_resident"),
    ("c2r_split", "irfft_resident", 1 << 21, "irfft_resident"),
    ("r2c_split", "rfft_split[resident_v6]", 1 << 17, "rfft_split[two_pass]"),
    ("c2r_split", "irfft_split[fourstep_vmem]", 1 << 22, "irfft_split[two_pass]"),
    ("r2c_split", "rfft_split[pallas_vmem]", 32768, "rfft_split[smem_rows]"),
    ("r2c_split", "rfft_split[threestep_vmem]", 1 << 23, "rfft_split[three_pass]"),
    ("c2r_split", "irfft_split[einsum]", 999, "irfft_split[einsum]"),
])
def test_plan_from_jax_real(kind, algorithm, n, want):
    plan = api.plan_from_jax(algorithm, n, kind=kind)
    assert (plan.kind, plan.n, plan.algorithm) == (kind, n, want)


@pytest.mark.parametrize("jax_route,n", [(None, 8192), ("resident_v6", 1 << 16)])
def test_plan_from_jax_carries_real_plans(monkeypatch, jax_route, n):
    """JAX r2c/c2r plans, read as plain values (kind, algorithm, n), become
    port plans that compute the same transforms."""
    if jax_route:
        monkeypatch.setenv("FFTLAB_FORCE_IMPL", jax_route)
    jr2c, jc2r = jx_api.plan_r2c_1d_split(n), jx_api.plan_c2r_1d_split(n)
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)
    r2c = api.plan_from_jax(jr2c.algorithm, jr2c.n, int(jr2c.direction), jr2c.kind)
    c2r = api.plan_from_jax(jc2r.algorithm, jc2r.n, int(jc2r.direction), jc2r.kind)
    assert r2c.kind == "r2c_split" and c2r.kind == "c2r_split"
    x = real(n, (2, n))
    got = r2c.execute(tt(x))
    want = jr2c.execute(jnp.asarray(x))
    assert snr_db(cplx(*got), cplx(*want)) >= 110.0
    back = c2r.execute(got).numpy()
    assert snr_db(back, np.asarray(jc2r.execute(want))) >= 110.0
    assert snr_db(back, x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("kind,algorithm,n,match", [
    ("r2c_split", "irfft_resident", 1 << 16, "unknown JAX r2c_split"),
    ("c2r_split", "irfft_split[two_pass]", 1 << 16, "unknown JAX c2r_split"),
    ("r2c_split", "rfft_resident", 1 << 23, "2\\^15, 2\\^20"),
    ("c2c_2d", "einsum", 64, "unknown JAX plan kind"),
])
def test_plan_from_jax_real_refuses(kind, algorithm, n, match):
    with pytest.raises(ValueError, match=match):
        api.plan_from_jax(algorithm, n, kind=kind)


# -------------------------------------------- kernels, counts and imports


def _all_launches():
    return {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES, **os_filter_vmem.LAUNCHES,
            **rfft_vmem.LAUNCHES, **stft_vmem.LAUNCHES}


@pytest.mark.parametrize("launch", [
    lambda x: rfft_vmem.pack_real(x),
    lambda x: rfft_vmem.interleave(x, x),
    lambda x: rfft_vmem.herm_unpack(x, x),
    lambda x: rfft_vmem.herm_repack(x[:, :1025], x[:, :1025]),
    lambda x: fourstep_vmem.fourstep_pass1_packed(x),
    lambda x: fourstep_vmem.fourstep_pass2_interleaved(x, x),
    lambda x: stft_vmem.stft_frames(x[0], 2048, 512, x[0, :2048], 4),
], ids=["pack_real", "interleave", "herm_unpack", "herm_repack",
        "fourstep_pass1_packed", "fourstep_pass2_interleaved", "stft_frames"])
def test_real_kernel_wrappers_refuse_cpu_tensors(launch):
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    a plain version in the kernel's name."""
    before = _all_launches()
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(2, 1 << 16))
    assert _all_launches() == before


def test_cpu_real_path_counts_no_launch():
    before = _all_launches()
    x = torch.zeros(1, 1 << 16)
    pt.irfft_split(*pt.rfft_split(x))
    pt.irfft_split(*pt.rfft_split(x[:, :8192]))
    fftlab_torch.plan_r2c_1d_split(1 << 16).execute(x)
    fftlab_torch.stft_split(x[0], 2048, 512)
    assert _all_launches() == before


def test_real_modules_import_without_jax():
    code = ("import sys, fftlab_torch, fftlab_torch.kernels.rfft_vmem, "
            "fftlab_torch.kernels.rfft_resident, fftlab_torch.kernels.stft_vmem, "
            "fftlab_torch.dsp.stft, fftlab_torch.dsp.spectrum; "
            "assert callable(fftlab_torch.plan_r2c_1d_split); "
            "bad = [m for m in ('jax', 'triton', 'fftlab') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
