"""fftlab_torch's span recorder on the CPU (fftlab_torch/utils/trace.py):
off by default, reading no clock; on under `recording()` and under a
torch.profiler profile, with the spans of a call nested as execute ->
dispatch -> wrapper (execute -> wrapper on a fused r2c/c2r plan) and a
public call inside another as a child; the
bounded buffer; the set-up spans and counters of the library, the
tables, the plans and the import. The launch spans, which only a card's
launch helpers record, are tested in tests/test_torch_cuda.py."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fftlab_torch.kernels import _build, fourstep_vmem
from fftlab_torch.plan.api import plan_dft_1d_split
from fftlab_torch.plan.dispatch import fft_split_auto, spectral_filter_auto
from fftlab_torch.utils import trace


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def fresh_setup(monkeypatch):
    """An empty list of set-up spans for the test, whatever the process
    has filled before it."""
    monkeypatch.setattr(trace, "_setup", [])


def _pair(n, rows=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, n, generator=g), torch.randn(rows, n, generator=g)


def _by_call(spans):
    calls = {}
    for i, s in enumerate(spans):
        calls.setdefault(s[4], []).append((i, s))
    return calls


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[3] == i]


def _self_ns(spans, i):
    return (spans[i][2] - spans[i][1]) - sum(spans[j][2] - spans[j][1]
                                             for j in _children(spans, i))


def _no_clock(*a, **k):
    raise AssertionError("the recorder read the clock while off")


def test_off_by_default_records_nothing_and_reads_no_clock(monkeypatch):
    plan = plan_dft_1d_split(1 << 15, device="cpu")
    x = _pair(1 << 15)
    h = torch.ones(1 << 15), torch.zeros(1 << 15)
    plan.execute(x)  # the tables' first builds: set-up, which reads the clock
    spectral_filter_auto(*x, *h)
    assert not trace.on()
    monkeypatch.setattr(trace, "now", _no_clock)
    monkeypatch.setattr(trace, "_sync_device", _no_clock)
    plan.execute(x)
    spectral_filter_auto(*x, *h)
    with trace.span("step"):  # no timers, recorder off: nothing at all
        pass
    assert trace.spans() == []


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_a_call_is_execute_dispatch_wrapper(mode):
    plan = plan_dft_1d_split(1 << 15, device="cpu")
    x = _pair(1 << 15)
    h = torch.ones(1 << 15), torch.zeros(1 << 15)
    plan.execute(x)
    spectral_filter_auto(*x, *h)
    assert not trace.on()
    ctx = (trace.recording() if mode == "recording"
           else profile(activities=[ProfilerActivity.CPU]))
    with ctx:
        assert trace.on()
        want = plan.execute(x)
        spectral_filter_auto(*x, *h)
        plan.execute(x)
    assert not trace.on()
    got = plan.execute(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    spans = trace.spans()
    assert [s[0] for s in spans] == ["execute", "dispatch", "wrapper"] * 3
    assert [s[3] for s in spans] == [-1, 0, 1, -1, 3, 4, -1, 6, 7]
    calls = _by_call(spans)
    assert len(calls) == 3 and all(len(v) == 3 for v in calls.values())
    for i, s in enumerate(spans):
        assert s[1] <= s[2]
        if s[3] >= 0:
            p = spans[s[3]]
            assert p[1] <= s[1] and s[2] <= p[2] and p[4] == s[4]
    for root in (0, 3, 6):  # self times add up to the root
        total = sum(_self_ns(spans, i) for i in (root, root + 1, root + 2))
        assert total == spans[root][2] - spans[root][1]


def test_a_public_call_inside_another_is_a_child():
    n = 1031  # prime, above the leaf: the chirp-z route through the sandwich
    plan = plan_dft_1d_split(n, device="cpu")
    x = _pair(n)
    plan.execute(x)
    with trace.recording():
        got = plan.execute(x)
    want = np.fft.fft(x[0].double().numpy() + 1j * x[1].double().numpy())
    assert np.allclose(got[0].double().numpy() + 1j * got[1].double().numpy(), want,
                       atol=1e-3 * np.abs(want).max())
    spans = trace.spans()
    names = [s[0] for s in spans]
    assert names[:3] == ["execute", "dispatch", "wrapper"]
    inner = [i for i, s in enumerate(spans) if s[0] == "execute" and i > 0]
    assert inner, names
    assert len({s[4] for s in spans}) == 1 and [s[3] for s in spans].count(-1) == 1
    for i in inner:
        p = spans[i][3]
        while spans[p][3] >= 0:
            p = spans[p][3]
        assert p == 0
        assert [spans[j][0] for j in _children(spans, i)] == ["dispatch"]


def test_fft_split_auto_is_a_root():
    x = _pair(1 << 15)
    with trace.recording():
        fft_split_auto(*x)
    assert [s[0] for s in trace.spans()] == ["execute", "dispatch", "wrapper"]


def _real_plan_and_input(kind):
    """A fused r2c or c2r plan at 2^16 (route `resident`), 2 rows, and its
    input."""
    from fftlab_torch.plan.api import plan_c2r_1d_split, plan_r2c_1d_split

    n = 1 << 16
    x = _pair(n)[0]
    r2c = plan_r2c_1d_split(n, batch=2, device="cpu")
    assert r2c.algorithm == "rfft_resident"
    if kind == "r2c":
        return r2c, x
    c2r = plan_c2r_1d_split(n, batch=2, device="cpu")
    assert c2r.algorithm == "irfft_resident"
    return c2r, r2c.execute(x)


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_a_fused_real_call_is_execute_wrapper(kind, monkeypatch):
    """The fused r2c/c2r route chose its kernels when the plan was made:
    its entry is the span `wrapper` right under `execute`, recorded while
    the recorder is on; off, the call reads no clock."""
    plan, x = _real_plan_and_input(kind)
    want = plan.execute(x)  # the tables' first builds
    with trace.recording():
        got = plan.execute(x)
    spans = trace.spans()
    assert [(s[0], s[3]) for s in spans] == [("execute", -1), ("wrapper", 0)]
    assert spans[0][1] <= spans[1][1] <= spans[1][2] <= spans[0][2]
    assert len({s[4] for s in spans}) == 1
    same = zip(got, want) if kind == "r2c" else [(got, want)]
    assert all(torch.equal(a, b) for a, b in same)
    trace.clear()
    monkeypatch.setattr(trace, "now", _no_clock)
    plan.execute(x)
    assert trace.spans() == []


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    plan = plan_dft_1d_split(1 << 15, device="cpu")
    x = _pair(1 << 15)
    plan.execute(x)
    monkeypatch.setattr(trace, "CAPACITY", 5)
    dropped = trace.COUNTS["spans_dropped"]
    with trace.recording():
        plan.execute(x)
        plan.execute(x)
        plan.execute(x)
    spans = trace.spans()
    assert len(spans) == 5 and trace.COUNTS["spans_dropped"] - dropped == 4
    assert [s[0] for s in spans] == ["execute", "dispatch", "wrapper", "execute",
                                     "dispatch"]
    assert all(s[2] > 0 for s in spans)
    trace.clear()
    assert trace.spans() == []


def test_capacity_holds_a_long_slice():
    assert trace.CAPACITY >= 1 << 18


def test_span_records_while_on_and_waits_only_with_timers(monkeypatch):
    monkeypatch.setattr(trace, "_sync_device", _no_clock)
    with trace.recording():
        with trace.span("step"):
            with trace.span("inner", sync=False):
                pass
    spans = trace.spans()
    assert [(s[0], s[3]) for s in spans] == [("step", -1), ("inner", 0)]
    timers = {}
    with trace.recording():
        with trace.span("timed", timers, sync=False):
            pass
    assert len(timers["timed"].laps) == 1 and trace.spans()[-1][0] == "timed"


def _table_spans(name):
    return sum(1 for s in trace.setup_spans() if s[0] == f"table.fourstep_vmem.{name}")


def test_tables_are_set_up_once_a_shape_never_on_a_hit(fresh_setup):
    key = "table_builds.fourstep_vmem._plain_pass1_twiddle"
    fourstep_vmem._plain_pass1_twiddle.cache_clear()
    plan = plan_dft_1d_split(1 << 16, device="cpu")
    x = _pair(1 << 16)
    before, spans_before = trace.COUNTS[key], _table_spans("_plain_pass1_twiddle")
    plan.execute(x)
    assert trace.COUNTS[key] - before == 1
    assert _table_spans("_plain_pass1_twiddle") - spans_before == 1
    with trace.recording():
        plan.execute(x)
    plan.execute(x)
    assert trace.COUNTS[key] - before == 1
    assert _table_spans("_plain_pass1_twiddle") - spans_before == 1
    assert not any(s[0].startswith("table.") for s in trace.spans())
    inverse = plan_dft_1d_split(1 << 16, direction=1, device="cpu")
    inverse.execute(x)  # another direction: another table
    assert trace.COUNTS[key] - before == 2


def test_the_import_is_the_first_set_up_span():
    first = trace.setup_spans()[0]
    assert first[0] == "import" and first[3] == -1 and first[2] > first[1]


def test_a_plan_is_a_set_up_span(fresh_setup):
    plan_dft_1d_split(1 << 15, device="cpu")
    assert [s[0] for s in trace.setup_spans()] == ["plan"]


def test_library_span_and_counters(monkeypatch, tmp_path, fresh_setup):
    """The loader's set-up spans and counters, with nvcc and dlopen
    replaced: a build, then a load of what is built."""
    def fake_compile(out):
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"")
        return out

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "compile_library", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    load = _build.load_library.__wrapped__  # past the process-wide cache
    builds, loads = trace.COUNTS["library_builds"], trace.COUNTS["library_loads"]
    for want_build in (True, False):
        before = len(trace.setup_spans())
        lib = load()
        assert lib.fftlab_fourstep_pass1.restype is _build.ctypes.c_int
        spans = trace.setup_spans()[before:]
        want = ["library", "digest", "build", "dlopen"] if want_build else \
            ["library", "digest", "dlopen"]
        assert [s[0] for s in spans] == want
        root = before + 0
        assert [s[3] for s in spans] == [-1] + [root] * (len(want) - 1)
        assert all(spans[0][1] <= s[1] and s[2] <= spans[0][2] for s in spans[1:])
    assert trace.COUNTS["library_builds"] - builds == 1
    assert trace.COUNTS["library_loads"] - loads == 2
