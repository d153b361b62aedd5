"""CPU tests of the three-pass readers (`metrics/pass_a_roofline.bulk.py`,
`pass_b_...`, `pass_c_...`) on synthetic slices, and of the work count
and least time of the single 2^24 c2c they are read against.

    python -m pytest cellbench -q
"""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from cellbench import harness  # noqa: E402
from cellbench import trace as tr  # noqa: E402

H100 = json.loads((HERE / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
CELL = "c2c_16m.bulk1"
# Each reader's operations by their short name.
PASSES = {"pass_a_roofline.bulk": "fourstep_pass1_kernel<0, 8>",
          "pass_b_roofline.bulk": "fourstep_pass1_kernel<2, 8>",
          "pass_c_roofline.bulk": "fourstep_pass2_kernel<0, 8>"}
# Operations of other kernels, and of the same templates at other lengths
# or modes, none of which a reader may count.
OTHERS = ["fourstep_pass1_kernel<0, 10>", "fourstep_pass1_kernel<2, 10>",
          "fourstep_pass2_kernel<0, 10>", "fourstep_pass1_kernel<4, 8>",
          "fourstep_pass1_kernel<0, 8>x", "Memset (Device)"]


def _raw(short: str) -> str:
    """The profiler's name of a kernel whose short name is `short`."""
    return f"void fftlab::{short}(float const*, float const*, fftlab::Geometry)" \
        if short.startswith("fourstep") else short


def _slice(durations: dict, calls: int) -> tr.Slice:
    """`calls` calls, each running every (short name, us) of `durations`
    back to back, from the profiler's events."""
    events, t = [], 1000.0
    for _ in range(calls):
        for short, dur in durations.items():
            events.append({"ph": "X", "cat": "kernel", "name": _raw(short), "ts": t,
                           "dur": dur})
            t += dur + 1.0
    return tr.read_slice(events, calls, 1000.0, t + 10.0, [])


def _record(sl, peaks=H100, nbytes=16 * 2**24) -> harness.Record:
    return harness.Record({"bytes": nbytes, "flops": 5 * 2**24 * 24}, peaks, 3, [], {}, sl)


def _read(name: str, record):
    return harness.load_module(ROOT, "metrics", name).read(record)


@pytest.mark.parametrize("name", sorted(PASSES))
def test_a_reader_sums_its_own_operations_over_the_calls(name):
    """Three calls of the three passes and of kernels of near names: the
    reader takes only its own, 160.26 us a call, twice its 80.13 us
    least time: 50%."""
    durations = {short: 100.0 + 10 * k for k, short in enumerate(OTHERS)}
    durations[PASSES[name]] = 160.26
    for short in PASSES.values():
        durations.setdefault(short, 999.0)
    got = _read(name, _record(_slice(durations, 3)))
    least_us = 16 * 2**24 / H100["bytes_per_s"] * 1e6
    assert got == pytest.approx(100.0 * least_us / 160.26)
    assert got == pytest.approx(50.0, abs=0.01)


@pytest.mark.parametrize("name", sorted(PASSES))
def test_a_reader_gives_nothing_without_its_operations(name):
    others = {short: 50.0 for short in OTHERS}
    assert _read(name, _record(_slice(others, 2))) is None
    own = {PASSES[name]: 100.0}
    assert _read(name, _record(_slice(own, 2), peaks=None)) is None
    assert _read(name, _record(None)) is None
    assert _read(name, _record(tr.Slice(0.0, 10.0, 2, [], []))) is None
    assert _read(name, _record(_slice(own, 2))) == pytest.approx(80.13, abs=0.01)


def test_the_cells_work_and_least_time():
    """One 2^24 c2c a call: 268,435,456 B in once and out once and
    5 * 2^24 * 24 flops; 0.0801 ms at 3.35 TB/s, the flops under it."""
    c = harness.load_cell(ROOT, CELL)
    assert c.config["n"] == 2**24 and c.traffic["rows"] == 1
    w = harness.load_module(ROOT, "work", c.config["kind"]).work(c.config, c.traffic)
    assert w == {"bytes": 268_435_456, "flops": 2_013_265_920}
    assert w["bytes"] / H100["bytes_per_s"] == pytest.approx(80.13e-6, rel=1e-3)
    assert w["flops"] / H100["flops_per_s"] < w["bytes"] / H100["bytes_per_s"]


def test_the_cell_reports_the_three_pass_rooflines():
    c = harness.load_cell(ROOT, CELL)
    names = {m["name"] for m in c.per_layer}
    assert set(PASSES) <= names and "unpack_pct.bulk" not in names
    for name in PASSES:
        m = next(m for m in c.per_layer if m["name"] == name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            "%", "higher", "device_trace", "kernels", "gsamples_per_s")
        assert m["workloads"] == [CELL]
        assert harness.load_module(ROOT, "metrics", name).KERNEL == PASSES[name]
