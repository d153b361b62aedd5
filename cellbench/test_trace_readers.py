"""CPU tests of the readers of the program's own spans
(`cellbench/program_spans.py` and the four metrics that use it), on
synthetic slices and spans: the base recovered from the harness's entry
spans, and no reading where the interval is empty or the slice's calls
and entry spans differ in number; the roots of the slice's warm calls
left out; a wide interval, and device operations off the host's clock,
dropped or added, change no reading.

    python -m pytest cellbench -q
"""

import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from cellbench import harness, program_spans  # noqa: E402
from cellbench import trace as tr  # noqa: E402

BASE = 1_790_000_000_000_000_000  # the trace's baseTimeNanoseconds
T0, T1 = 1000.0, 2000.0
READERS = ("host_path_us.bulk", "wrapper_us.bulk", "launch_call_us.bulk",
           "setup_program_s.bulk")


def ns(us: float) -> int:
    """A trace time in microseconds as the recorder's time_ns stamp."""
    return BASE + round(us * 1e3)


class Spans:
    """Recorder spans (name, start_ns, end_ns, parent, call), built in
    trace microseconds."""

    def __init__(self):
        self.spans = []

    def add(self, name, s, e, parent=-1, call=0):
        self.spans.append((name, ns(s), ns(e), parent, call))
        return len(self.spans) - 1

    def launch(self, kernel, s, e, call_s, parent, call):
        i = self.add(kernel, s, e, parent, call)
        self.add("checks", s, call_s, i, call)
        self.add("call", call_s, e, i, call)


def entry_of(k):
    return 1010.0 + 400.0 * k, 1200.0 + 400.0 * k


def build(slack=0.5, calls=2, warm=1):
    """`calls` calls whose roots lie `slack` us inside their entry spans,
    after `warm` warm calls before T0; each call launches pass 1 (35 us of
    checks, a 10 us call) and pass 2 (20 us of checks, a 20 us call)."""
    sp = Spans()
    for w in range(warm):
        sp.add("execute", 100.0 + 50 * w, 120.0 + 50 * w, call=100 + w)
    for k in range(calls):
        e0, e1 = entry_of(k)
        root = sp.add("execute", e0 + slack, e1 - slack, call=k)
        d = sp.add("dispatch", e0 + 1, e1 - 1, root, k)
        w = sp.add("wrapper", e0 + 2, e1 - 2, d, k)
        sp.launch("fourstep_pass1", e0 + 5, e0 + 50, e0 + 40, w, k)
        sp.launch("fourstep_pass2", e0 + 60, e0 + 100, e0 + 80, w, k)
    return sp.spans


# Device operations: each call's two passes, after their launches.
OPS = [("fourstep_pass1_kernel<0, 10>", 1062.0, 1150.0),
       ("fourstep_pass2_kernel<0, 10>", 1160.0, 1310.0),
       ("fourstep_pass1_kernel<0, 10>", 1465.0, 1590.0),
       ("fourstep_pass2_kernel<0, 10>", 1600.0, 1700.0)]


def make_slice(calls=2, ops=OPS):
    host = []
    for k in range(2):
        e0, e1 = entry_of(k)
        host += [("next_input", e0 - 5, e0), ("entry", e0, e1)]
    host.append(("sync", 1800.0, 1990.0))
    return tr.Slice(T0, T1, calls, list(ops), host)


SETUP = [("import", 0, 100_000_000, -1, 0),
         ("library", 200_000_000, 500_000_000, -1, 1),
         ("digest", 200_000_000, 300_000_000, 1, 1),
         ("table.fourstep_vmem._pass1_tables", 600_000_000, 700_000_000, -1, 2)]


@pytest.fixture
def program(monkeypatch):
    """Install a recorder holding `spans` (and SETUP) where the readers
    look for fftlab_torch's."""
    def install(spans, setup=SETUP):
        mod = types.ModuleType(program_spans.RECORDER)
        mod.spans = lambda: list(spans)
        mod.setup_spans = lambda: list(setup)
        monkeypatch.setitem(sys.modules, program_spans.RECORDER, mod)
    return install


def read_all(sl):
    rec = harness.Record({"bytes": 1, "flops": 1}, None, 2, [], {}, sl)
    return {name: harness.load_module(ROOT, "metrics", name).read(rec) for name in READERS}


def test_readers_on_a_slice(program):
    program(build())
    got = read_all(make_slice())
    assert got["host_path_us.bulk"] == pytest.approx(189.0)
    assert got["wrapper_us.bulk"] == pytest.approx(35.0 + 20.0)
    assert got["launch_call_us.bulk"] == pytest.approx(15.0)
    assert got["setup_program_s.bulk"] == pytest.approx(0.1 + 0.3 + 0.1)


def test_base_is_recovered_within_the_slack(program):
    ps = program_spans.program_slice(make_slice(), build(slack=0.5))
    assert ps.base_width_ns == pytest.approx(1000.0)
    assert ps.roots[0] == pytest.approx((1010.5, 1199.5), abs=0.5)
    assert [ln.kernel for ln in ps.launches] == ["fourstep_pass1", "fourstep_pass2"] * 2
    assert [ln.call for ln in ps.launches] == [0, 0, 1, 1]


def test_warm_roots_are_left_out(program):
    for warm in (0, 1, 4):
        program(build(warm=warm))
        assert read_all(make_slice())["host_path_us.bulk"] == pytest.approx(189.0)


def test_no_reading_where_the_clocks_disagree(program):
    spans = build()
    # the second call's root 300 us after its entry span
    spans = [(n, s + 300_000, e + 300_000, p, c) if c == 1 else (n, s, e, p, c)
             for n, s, e, p, c in spans]
    program(spans)
    lo, hi = program_spans.base_interval(
        [(s, e) for n, s, e, p, c in spans if n == "execute" and c < 100],
        [entry_of(0), entry_of(1)])
    assert lo > hi
    got = read_all(make_slice())
    assert all(got[name] is None for name in READERS[:3])
    assert got["setup_program_s.bulk"] is not None


def test_a_wide_interval_still_reads(program):
    program(build(slack=1.5))  # 3 us between the bounds
    assert read_all(make_slice())["host_path_us.bulk"] == pytest.approx(187.0)
    program(build(slack=20.0))  # 40 us
    got = read_all(make_slice())
    assert got["host_path_us.bulk"] == pytest.approx(150.0)
    assert got["wrapper_us.bulk"] == pytest.approx(35.0 + 20.0)
    assert got["launch_call_us.bulk"] == pytest.approx(15.0)


def test_no_reading_where_the_calls_do_not_match(program):
    program(build())
    got = read_all(make_slice(calls=3))
    assert all(got[name] is None for name in READERS[:3])
    program(build(calls=1))
    assert all(read_all(make_slice())[name] is None for name in READERS[:3])


@pytest.mark.parametrize("ops", [
    [(n, s - 200.0, e - 200.0) for n, s, e in OPS],  # the device's times 200 us early
    [(n, s + 90.0, e + 90.0) for n, s, e in OPS],  # 90 us late
    OPS[:3],  # a record dropped
    [("fourstep_pass2_kernel<0, 10>", 950.0, 1005.0), *OPS],  # a warm call's straddles T0
    [],
], ids=["early", "late", "dropped", "straddles", "none"])
def test_readings_need_no_device_clock(program, ops):
    program(build())
    assert read_all(make_slice(ops=ops)) == read_all(make_slice())


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, program_spans.RECORDER, raising=False)
    assert all(v is None for v in read_all(make_slice()).values())
    bare = types.ModuleType(program_spans.RECORDER)  # the parent's trace module
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, bare)
    assert all(v is None for v in read_all(make_slice()).values())


def test_setup_needs_a_traced_slice(program):
    program(build())
    rec = harness.Record({"bytes": 1, "flops": 1}, None, 0, [], {}, None)
    assert harness.load_module(ROOT, "metrics", "setup_program_s.bulk").read(rec) is None
    program(build(), setup=[])
    assert read_all(make_slice())["setup_program_s.bulk"] is None


def test_program_spans_imports_nothing_of_the_program():
    from cellbench.test_cellbench_imports import JAX, PROGRAM, imported

    for path in (HERE / "program_spans.py",
                 *(HERE / "metrics" / f"{name}.py" for name in READERS)):
        assert not imported(path) & (PROGRAM | JAX), path
