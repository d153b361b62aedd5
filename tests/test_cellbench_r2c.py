"""The r2c configuration of the port's benchmark (`cellbench/`, cell
`r2c_2m.bulk16`) on the CPU: its program against its plain reference at
a size the CPU holds, the TF32 control far under the contract, the work
count at the cell's shape, the `unpack_pct.bulk` reader on synthetic
slices, and a reference that loads nothing of the program or of JAX.

The cellbench suite (`python -m pytest cellbench -q`) runs the harness
on every cell; these tests hold the r2c files themselves."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cellbench import compare, harness  # noqa: E402
from cellbench import trace as tr  # noqa: E402

CONFIG = json.loads((ROOT / "cellbench" / "configs" / "r2c_2m.json").read_text())
BULK16 = json.loads((ROOT / "cellbench" / "traffic" / "bulk16.json").read_text())
CPU_N, CPU_ROWS = 1 << 16, 4
SEED = 2**33 + 2121


def _module(folder):
    return harness.load_module(ROOT, folder, "r2c")


def _rows(rows, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, n, generator=g), torch.randn(rows, n, generator=g)


def test_configuration():
    assert (CONFIG["kind"], CONFIG["n"], CONFIG["route"]) == ("r2c", 2**21, "rfft_resident")
    assert CONFIG["contract"] == {"worst_row_snr_db": 110} and CONFIG["reduced"] == []
    assert CONFIG["cpu_test"] == {
        "breaks": "fftlab_torch.kernels.rfft_resident:rfft_resident"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "r2c_2m")
    assert entry["source"] == CONFIG["source"] and len(entry["source"]) <= 200
    cell = harness.load_cell(ROOT, "r2c_2m.bulk16")
    assert cell.chips == 1 and cell.traffic == BULK16
    assert "unpack_pct.bulk" in {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("seed", [SEED, 7])
def test_program_matches_the_reference(seed):
    """The cell's entry at 2^16 x 4 rows on the CPU, where the plan takes
    the cell's route and runs the plain versions of its launches: every
    row at the contract or above."""
    cfg = {**CONFIG, "n": CPU_N}
    call, route = _module("program").build(cfg, {**BULK16, "rows": CPU_ROWS}, {}, "cpu")
    assert route == CONFIG["route"]
    xr, xi = _rows(CPU_ROWS, CPU_N, seed)
    yr, yi = call(xr, xi)
    assert tuple(yr.shape) == tuple(yi.shape) == (CPU_ROWS, CPU_N // 2 + 1)
    want = _module("reference").reference(xr, xi, {}, cfg, "forward")
    snr = compare.row_snr_db(yr, yi, want)
    assert len(snr) == CPU_ROWS
    assert min(snr) >= CONFIG["contract"]["worst_row_snr_db"], snr


def test_program_refuses_an_inverse():
    with pytest.raises(ValueError, match="forward"):
        _module("program").build({**CONFIG, "n": CPU_N}, {**BULK16, "direction": "inverse"},
                                 {}, "cpu")


@pytest.mark.parametrize("n", [4, 16, 256, 4096])
def test_reference_is_numpy(n):
    ref = _module("reference")
    xr, xi = _rows(3, n, n)
    got = ref.reference(xr, xi, ref.make_constants({"n": n}, None, "cpu"), {"n": n},
                        "forward")
    x = xr.double().numpy()
    np.testing.assert_allclose(got.numpy(), np.fft.rfft(x), rtol=0, atol=1e-12 * n)
    k = np.arange(n // 2 + 1)
    dft = x @ np.exp(-2j * np.pi * np.outer(np.arange(n), k) / n)  # DC .. Nyquist
    np.testing.assert_allclose(got.numpy(), dft, atol=1e-9 * n)
    with pytest.raises(ValueError, match="forward"):
        ref.reference(xr, xi, {}, {"n": n}, "inverse")


def test_control_fails_the_contract():
    """TF32 operands: far under the 110 dB contract, far over noise."""
    ref = _module("reference")
    xr, xi = _rows(2, CPU_N, SEED)
    yr, yi = ref.control(xr, xi, {}, {"n": CPU_N}, "forward")
    snr = compare.row_snr_db(yr, yi, ref.reference(xr, xi, {}, {"n": CPU_N}, "forward"))
    assert all(50 < s < 90 for s in snr), snr


def test_work_at_the_cells_shape():
    """16 x 2^21 reals in, 16 x (2^20 + 1) bins out: 268 MB, 0.0801 ms at
    3.35 TB/s, over the flops' time at 67 TFLOP/s."""
    w = _module("work").work(CONFIG, BULK16)
    assert w == {"bytes": 16 * (8 * 2**21 + 8), "flops": 16 * 5 * 2**21 * 21 // 2}
    peaks = json.loads((ROOT / "cellbench" / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    assert w["bytes"] / peaks["bytes_per_s"] == pytest.approx(80.13e-6, rel=1e-3)
    assert w["flops"] / peaks["flops_per_s"] < w["bytes"] / peaks["bytes_per_s"]


def _record(ops):
    events = [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
              for name, ts, dur in ops]
    sl = tr.read_slice(events, 2, 1000.0, 2000.0, [("entry", 1000.0, 1100.0)])
    return harness.Record({"bytes": 1, "flops": 1}, None, 2, [], {}, sl)


PASS1 = "void fftlab::fourstep_pass1_kernel<1, 10>(float const*, float*, float*)"
PASS2 = "void fftlab::fourstep_pass2_kernel<0, 10>(float const*, float const*, float*)"
# As the H100's profiler names the unpack: no "void", no namespace.
UNPACK = "herm_unpack_kernel(float const*, float const*, float*, float*, float2 const*, " \
         "long long, int, float)"


@pytest.mark.parametrize("ops, want", [
    ([(PASS1, 1010.0, 40.0), (PASS2, 1050.0, 30.0), (UNPACK, 1080.0, 30.0),
      (PASS1, 1200.0, 40.0), (PASS2, 1240.0, 30.0), (UNPACK, 1270.0, 30.0)], 30.0),
    ([(PASS1, 1010.0, 60.0), (UNPACK, 1070.0, 20.0), ("Memset (Device)", 1090.0, 20.0)],
     20.0),
    ([(PASS1, 1010.0, 70.0), ("void fftlab::herm_unpack_kernel(float const*)", 1080.0, 30.0)],
     30.0),
    ([(PASS1, 1010.0, 40.0), (PASS2, 1050.0, 30.0)], 0.0),
    ([], None),
], ids=["three_launches", "with_a_memset", "signature_name", "no_unpack",
         "no_device_operation"])
def test_unpack_share(ops, want):
    got = harness.load_module(ROOT, "metrics", "unpack_pct.bulk").read(_record(ops))
    assert got == (None if want is None else pytest.approx(want))


def test_unpack_share_without_a_slice():
    rec = harness.Record({"bytes": 1, "flops": 1}, None, 2, [], {}, None)
    assert harness.load_module(ROOT, "metrics", "unpack_pct.bulk").read(rec) is None


def test_reference_loads_nothing_of_the_program():
    """Imported alone, as the harness loads it on the card's host: no JAX,
    no JAX package, no fftlab_torch."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from pathlib import Path; from cellbench import harness; "
            "ref = harness.load_module(Path(sys.argv[1]), 'reference', 'r2c'); "
            "print(json.dumps([harness.foreign_modules(), "
            "sorted(m for m in sys.modules if m.split('.')[0] == 'fftlab_torch')]))")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [[], []]

