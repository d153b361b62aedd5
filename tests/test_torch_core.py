"""fftlab_torch core: import hygiene, types, owned tables, radix
planning, flags and the device report, held equal to the JAX package.

Tables are compared with np.array_equal: both packages build them in
float64 numpy with the same code, so they must agree bit for bit."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fftlab.algos.stockham as jx_stockham
import fftlab.core.twiddle as jx_twiddle
import fftlab.core.types as jx_types
import fftlab.plan.flags as jx_flags
from fftlab_torch.algos import stockham
from fftlab_torch.core import twiddle, types
from fftlab_torch.plan import flags, hardware

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fftlab_torch"


def test_import_loads_no_jax_triton_or_cuda():
    code = ("import sys, fftlab_torch, fftlab_torch.plan.api, "
            "fftlab_torch.kernels.fft_vmem, fftlab_torch.kernels.resident_vmem; "
            "bad = [m for m in ('jax', 'triton', 'fftlab') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax_or_fftlab(path):
    bad = re.compile(r"^\s*(import|from)\s+(jax|fftlab)(\.|\s|$)", re.M)
    assert not bad.search(path.read_text())


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|fftlab)(\.|\s|$)", src, re.M)


def test_chip_smoke_alone_refuses(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_direction_values():
    assert {d.name: int(d) for d in types.Direction} == {
        d.name: int(d) for d in jx_types.Direction}
    assert types.FORWARD == jx_types.FORWARD == -1
    assert types.INVERSE == jx_types.INVERSE == 1


def test_integer_helpers():
    for n in range(0, 4100):
        assert types.is_power_of_two(n) == jx_types.is_power_of_two(n)
        if jx_types.is_power_of_two(n):
            assert types.log2_int(n) == jx_types.log2_int(n)
    with pytest.raises(ValueError):
        types.log2_int(12)


@pytest.mark.parametrize("n", [1, 2, 8, 100, 128, 1024])
@pytest.mark.parametrize("direction", [-1, 1])
def test_dft_matrix_equal(n, direction):
    assert np.array_equal(twiddle.dft_matrix_np(n, direction),
                          jx_twiddle.dft_matrix_np(n, direction))


@pytest.mark.parametrize("r,m", [(2, 4), (64, 128), (128, 128), (3, 7), (8, 1024)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_stage_twiddle_equal(r, m, direction):
    assert np.array_equal(twiddle.stage_twiddle_np(r, m, direction),
                          jx_twiddle.stage_twiddle_np(r, m, direction))


@pytest.mark.parametrize("n", [1, 7, 64, 128, 1000, 4096, 6000, 1 << 15,
                               1 << 20, 1 << 21, 3 * 5 * 7 * 11 * 13])
@pytest.mark.parametrize("leaf", [128, 1024])
def test_plan_factors_equal(n, leaf):
    assert stockham.plan_factors(n, leaf) == jx_stockham.plan_factors(n, leaf)
    assert stockham.max_prime_factor(n) == jx_stockham.max_prime_factor(n)


def test_plan_factors_refuses_large_prime():
    with pytest.raises(ValueError, match="Bluestein"):
        stockham.plan_factors(2 * 257, 128)


def test_flags_equal():
    assert {f.name: int(f) for f in flags.Flags} == {
        f.name: int(f) for f in jx_flags.Flags}
    cfg = flags.PlanConfig()
    assert cfg.flags == flags.Flags.ESTIMATE == jx_flags.PlanConfig().flags
    assert hash(cfg) == hash(flags.PlanConfig())


def test_detect_hardware_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    caps = hardware.detect_hardware()
    assert caps.platform == "cpu"
    assert caps.sm_count is None and "platform=cpu" in caps.summary()
