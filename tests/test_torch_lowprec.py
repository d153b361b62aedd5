"""The reduced-precision modes (fftlab_torch.algos.lowprec) and the
`precision=` of the port's `fft_split` (counterpart of
fftlab/algos/lowprec.py).

'f32' is held against the JAX function's 'f32' (Precision.HIGHEST) at
>= 120 dB, the JAX suite's c2c gate. The reduced modes are held against
float64 and the ordering the card's gates use (f32 >= f32x3 >= bf16 >
20 dB), not against JAX: the JAX CPU einsum ignores its precision
argument, so tests/test_aux.py:49-54 reads > 100 dB for 'bf16', while
PyTorch's "medium" tier runs bfloat16 on a CPU whose oneDNN has
bfloat16 kernels (about 50 dB) and TF32 on the H100 (about 68 dB). The
inputs are float32 on both sides (jax x64 is on, tests/conftest.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cplx, jax_native, oracle, planes, snr_db, tt
from fftlab.algos import lowprec as jx
from fftlab_torch.algos import lowprec
from fftlab_torch.algos.split_stockham import fft_split
from fftlab_torch.core import precision

SHAPES = [(2, 4096), (3, 1000)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("direction", [-1, 1])
def test_f32_matches_jax(shape, direction):
    xr, xi = planes(shape[-1], shape)
    got = cplx(*lowprec.fft_split_lowprec(tt(xr), tt(xi), direction, mode="f32"))
    want = cplx(*jx.fft_split_lowprec(jnp.asarray(xr), jnp.asarray(xi), direction,
                                      mode="f32"))
    assert snr_db(got, want) >= 120.0
    scale = 1.0 / shape[-1] if direction == 1 else 1.0
    assert snr_db(got, oracle(xr, xi, direction, scale)) >= 120.0


def test_modes_against_float64_in_order():
    xr, xi = planes(5, (2, 4096))
    want = oracle(xr, xi, -1)
    snr = {m: snr_db(cplx(*lowprec.fft_split_lowprec(tt(xr), tt(xi), mode=m)), want)
           for m in lowprec.PRECISIONS}
    assert snr["f32"] >= 120.0
    assert snr["f32"] >= snr["f32x3"] >= snr["bf16"] > 20.0


def test_bad_mode_raises_as_jax():
    x = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        lowprec.fft_split_lowprec(x, x, mode="fp8")
    with pytest.raises(ValueError):
        jx.fft_split_lowprec(jnp.zeros((1, 8)), jnp.zeros((1, 8)), mode="fp8")
    with pytest.raises(ValueError):
        precision.matmul_precision("low")


def test_mode_names_match_jax():
    assert set(lowprec.PRECISIONS) == set(jx._PRECISIONS)


@pytest.mark.parametrize("setting", ["medium", "high", "highest"])
@pytest.mark.parametrize("mode", list(lowprec.PRECISIONS))
def test_caller_settings_restored(setting, mode):
    torch.set_float32_matmul_precision(setting)
    conv = torch.backends.cudnn.allow_tf32
    try:
        before = (torch.get_float32_matmul_precision(),
                  torch.backends.cuda.matmul.allow_tf32,
                  [b.fp32_precision for b in precision._conv_backends()])
        x = torch.ones(2, 64)
        lowprec.fft_split_lowprec(x, x, mode=mode)
        after = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32,
                 [b.fp32_precision for b in precision._conv_backends()])
        assert after == before
        assert torch.backends.cudnn.allow_tf32 == conv
    finally:
        torch.set_float32_matmul_precision("highest")


def test_mode_applies_inside_the_block():
    seen = []
    with precision.matmul_precision("medium"):
        seen.append(torch.get_float32_matmul_precision())
        with precision.matmul_precision("high"):
            seen.append(torch.get_float32_matmul_precision())
        seen.append(torch.get_float32_matmul_precision())
    assert seen == ["medium", "high", "medium"]
    assert torch.get_float32_matmul_precision() == "highest"


def test_reduced_block_never_lowers_a_full_block():
    """A reduced block opened while another thread's full_float32 block is
    open runs at full precision; it gets its tier when the full block
    leaves, and the caller's setting comes back when both have left."""
    full_open, reduced_open, full_left = (threading.Event() for _ in range(3))
    seen = {}

    def full():
        with precision.full_float32():
            full_open.set()
            reduced_open.wait(30)
            seen["full, both open"] = torch.get_float32_matmul_precision()
        full_left.set()

    def reduced():
        full_open.wait(30)
        with precision.matmul_precision("medium"):
            reduced_open.set()
            full_left.wait(30)
            seen["reduced alone"] = torch.get_float32_matmul_precision()

    torch.set_float32_matmul_precision("high")
    try:
        threads = [threading.Thread(target=f) for f in (full, reduced)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert seen == {"full, both open": "highest", "reduced alone": "medium"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")


def test_fft_split_takes_precision_in_jax_position():
    """ROADMAP Queue 3 fault 3: `fft_split(xr, xi, direction, leaf,
    precision)` as the JAX function takes it."""
    xr, xi = planes(9, (2, 2048))
    got = cplx(*fft_split(tt(xr), tt(xi), -1, 128, "highest"))
    assert snr_db(got, cplx(*fft_split(tt(xr), tt(xi)))) >= 150.0
    want = cplx(*jx.fft_split_lowprec(jnp.asarray(xr), jnp.asarray(xi), mode="f32"))
    assert snr_db(got, want) >= 120.0


def test_snr_vs_oracle_rows_as_jax():
    jax_native()
    got = lowprec.snr_vs_oracle(n=1024, device="cpu")
    want = jx.snr_vs_oracle(n=1024)
    assert set(got) == set(want) == {"f32", "f32x3", "bf16", "q15"}
    assert got["q15"] == want["q15"]  # the same C++ on the same input
    assert got["f32"] >= 120.0 and want["f32"] >= 120.0


def test_snr_vs_oracle_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lowprec.snr_vs_oracle(n=64)
