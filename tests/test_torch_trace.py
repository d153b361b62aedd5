"""fftlab_torch's span recorder on the CPU (fftlab_torch/utils/trace.py):
off by default, reading no clock; on under `recording()` and under a
torch.profiler profile, with the spans of a call nested as execute ->
dispatch -> wrapper (execute -> wrapper on a fused r2c/c2r plan) and a
public call inside another as a child; the
bounded buffer; the set-up spans and counters of the library, the
tables, the plans and the import; the one launch path,
`kernels/_build.launch`, with a fake library (its argument order, count,
error, span and off path), and a check of the sources that no other
code calls a kernel entry or records a launch. The launch spans of the
card's wrappers are tested in tests/test_torch_cuda.py."""

import ast
import contextlib
import ctypes
import importlib
import pathlib
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fftlab_torch.core.types import Direction
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


STREAM = 0x5EED


def _fake_launch(monkeypatch, rc: int = 0) -> list:
    """`_build.launch`'s world on the CPU: a library whose `fftlab_fft_rows`
    returns `rc` and records its arguments and the time, and the device
    guard and the stream patched so that a CPU tensor passes. Returns the
    list of calls."""
    calls = []

    def entry(*args):
        calls.append((args, time.time_ns()))  # the recorder's clock, not its `now`
        return rc

    lib = types.SimpleNamespace(fftlab_fft_rows=entry,
                                fftlab_error_string=lambda code: b"an error")
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=STREAM))
    return calls


def _launch(counts, mark=trace.OFF):
    _build.launch("fftlab_fft_rows", "fft_rows", counts, torch.zeros(2, 8), (11, 22, 0.5),
                  mark)


def _arguments_in_order_stream_last(monkeypatch, counts):
    calls = _fake_launch(monkeypatch)
    _launch(counts)
    assert [args for args, _ in calls] == [(11, 22, 0.5, STREAM)]


def _one_count_under_its_key(monkeypatch, counts):
    _fake_launch(monkeypatch)
    _launch(counts)
    _launch(counts)
    assert counts == {"fft_rows": 6, "filter_rows": 0}


def _an_error_names_the_kernel_and_counts_nothing(monkeypatch, counts):
    calls = _fake_launch(monkeypatch, rc=719)
    with pytest.raises(RuntimeError, match=r"^fft_rows failed: CUDA error 719 \(an error\)$"):
        _launch(counts)
    assert len(calls) == 1 and counts == {"fft_rows": 4, "filter_rows": 0}


def _recorded_with_four_phases_under_the_wrapper(monkeypatch, counts):
    calls = _fake_launch(monkeypatch)
    with trace.recording():
        wrapper = trace.begin("wrapper")
        mark = trace.phases()
        mark()
        mark()
        _launch(counts, mark)
        trace.end(wrapper)
    spans = trace.spans()
    assert [s[0] for s in spans] == ["wrapper", "fft_rows", *trace.PHASES]
    assert [s[3] for s in spans] == [-1, 0, 1, 1, 1, 1]
    assert len({s[4] for s in spans}) == 1
    kernel, phases = spans[1], spans[2:]
    assert spans[0][1] <= kernel[1] <= kernel[2] <= spans[0][2]
    assert phases[0][1] == kernel[1] and phases[-1][2] == kernel[2]
    assert all(a[2] == b[1] for a, b in zip(phases, phases[1:]))
    assert phases[-1][1] <= calls[0][1] <= phases[-1][2]  # the entry runs in `call`
    assert counts["fft_rows"] == 5


def _a_double_mark_is_a_phase_of_zero_length(monkeypatch, counts):
    _fake_launch(monkeypatch)
    with trace.recording():
        mark = trace.phases()
        mark(2)
        _launch(counts, mark)
    spans = trace.spans()
    assert [s[0] for s in spans] == ["fft_rows", *trace.PHASES]
    assert spans[2][1] == spans[2][2] and spans[3][1] == spans[2][2]


def _off_reads_no_clock_and_records_nothing(monkeypatch, counts):
    calls = _fake_launch(monkeypatch)
    assert not trace.on()
    monkeypatch.setattr(trace, "now", _no_clock)
    mark = trace.phases()
    assert mark is trace.OFF
    mark()
    mark(2)
    _launch(counts, mark)
    assert trace.spans() == [] and counts["fft_rows"] == 5


@pytest.mark.parametrize("aspect", [
    _arguments_in_order_stream_last, _one_count_under_its_key,
    _an_error_names_the_kernel_and_counts_nothing,
    _recorded_with_four_phases_under_the_wrapper, _a_double_mark_is_a_phase_of_zero_length,
    _off_reads_no_clock_and_records_nothing], ids=lambda f: f.__name__.strip("_"))
def test_the_one_launch_path(aspect, monkeypatch):
    """`kernels/_build.launch` with a fake library, on a CPU tensor."""
    aspect(monkeypatch, {"fft_rows": 4, "filter_rows": 0})


PORT = pathlib.Path(__file__).resolve().parent.parent / "fftlab_torch"
# Where the library is called from, the one place: kernels/_build.py `launch`.
LAUNCH_SITE = ("kernels/_build.py", "launch")


def _calls(pred) -> list:
    """(module, enclosing function) of every call in fftlab_torch/ whose
    callee `pred` takes: its function's node (a Name or an Attribute)."""
    sites = []

    def visit(node, module, fn):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                     else fn)
            if isinstance(child, ast.Call) and pred(child.func):
                sites.append((module, fn))
            visit(child, module, inner)

    for path in sorted(PORT.rglob("*.py")):
        visit(ast.parse(path.read_text()), path.relative_to(PORT).as_posix(), None)
    return sites


def _attr(*names):
    return lambda f: isinstance(f, ast.Attribute) and f.attr in names


def _entries_rule():
    entries = {*_build.SIGNATURES, "fftlab_error_string"}
    by_name = lambda f: isinstance(f, ast.Call) and getattr(f.func, "id", None) == "getattr"  # noqa: E731
    return set(_calls(_attr(*entries)) + _calls(by_name)) == {LAUNCH_SITE}


def _library_rule():
    return set(_calls(lambda f: getattr(f, "id", getattr(f, "attr", None)) == "load_library")
               ) == {LAUNCH_SITE}


def _span_rule():
    launch_span = lambda f: (isinstance(f, ast.Attribute) and f.attr == "launch"  # noqa: E731
                             and getattr(f.value, "id", None) == "trace")
    return (set(_calls(launch_span)) == {LAUNCH_SITE} and not _calls(_attr("launch_call", "check"))
            and not hasattr(trace, "launch_call") and not hasattr(_build, "check"))


def _named_entry_rule():
    """Each `_build.launch` call names its C entry as a literal, and no
    code of kernels/ compares a string with a kernel's LAUNCHES key."""
    keys = set()
    for path in (PORT / "kernels").glob("*.py"):
        keys |= set(getattr(importlib.import_module(f"fftlab_torch.kernels.{path.stem}"),
                            "LAUNCHES", {}))
    assert "fourstep_pass2_interleaved" in keys
    named = []
    for path in (PORT / "kernels").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and _attr("launch")(node.func) and \
                    getattr(node.func.value, "id", None) == "_build":
                named.append(isinstance(node.args[0], ast.Constant)
                             and node.args[0].value in _build.SIGNATURES)
            if isinstance(node, ast.Compare) and any(
                    isinstance(c, ast.Constant) and c.value in keys
                    for c in (node.left, *node.comparators)):
                return False
    return len(named) >= 14 and all(named)


@pytest.mark.parametrize("rule", [_entries_rule, _library_rule, _span_rule, _named_entry_rule],
                         ids=lambda f: f.__name__.strip("_"))
def test_only_the_launch_path_calls_the_library(rule):
    """No module of fftlab_torch/ but kernels/_build.py `launch` calls a
    kernel entry, loads the library for a call or records a launch span;
    `trace.launch_call` and `_build.check` are gone, and no wrapper picks
    its entry by a kernel's name."""
    assert rule()


class _CheckedLib:
    """A kernel library whose entries take their arguments through ctypes
    prototypes of `_build.SIGNATURES`, so that an argument the real
    library would refuse raises here (ctypes.ArgumentError), and record
    (entry, the arguments as C sees them)."""

    def __init__(self):
        self.calls = []
        for name, sig in _build.SIGNATURES.items():
            setattr(self, name, self._entry(name, sig))

    def _entry(self, name, sig):
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *sig)(
            lambda *args: self.calls.append((name, args)) or 0)

        def entry(*args):
            assert len(args) == len(sig), (name, len(args), len(sig))
            return proto(*args)
        return entry

    def fftlab_error_string(self, rc):
        return b"an error"


def _planes(*shape):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(*shape, generator=g), torch.randn(*shape, generator=g)


def _kernels(name):
    return importlib.import_module(f"fftlab_torch.kernels.{name}")


# Every launch site: (its LAUNCHES key, its C entry, a call of it on CPU
# tensors at the smallest shape it takes).
WRAPPERS = [
    ("fft_rows", "fftlab_fft_rows", lambda: _kernels("fft_vmem").fft_rows(*_planes(2, 512))),
    ("filter_rows", "fftlab_filter_rows",
     lambda: _kernels("fft_vmem").filter_rows(*_planes(2, 512), *_planes(512))),
    ("os_filter", "fftlab_os_filter",
     lambda: _kernels("os_filter_vmem").os_filter(*_planes(2, 1000), *_planes(512), 9)),
    ("stft_frames", "fftlab_stft_frames",
     lambda: _kernels("stft_vmem").stft_frames(_planes(4096)[0], 1024, 256,
                                               torch.ones(1024), 13)),
    ("fused_stage", "fftlab_fused_stage",
     lambda: _kernels("stage_fused")._launch(*_planes(4, 512), 4, Direction.FORWARD, True, 2)),
    ("stage_leaf", "fftlab_stage_leaf",
     lambda: _kernels("stage_fused").stage_leaf(*_planes(2, 512), 128)),
    ("pack_real", "fftlab_pack_real", lambda: _kernels("rfft_vmem").pack_real(_planes(2, 64)[0])),
    ("interleave", "fftlab_interleave",
     lambda: _kernels("rfft_vmem").interleave(*_planes(2, 32))),
    ("herm_unpack", "fftlab_herm_unpack",
     lambda: _kernels("rfft_vmem").herm_unpack(*_planes(2, 32), 0.5)),
    ("herm_repack", "fftlab_herm_repack",
     lambda: _kernels("rfft_vmem").herm_repack(*_planes(2, 33))),
    ("fourstep_pass1", "fftlab_fourstep_pass1",
     lambda: fourstep_vmem.fourstep_pass1(*_planes(2, 1 << 15), -1)),
    ("fourstep_pass1", "fftlab_fourstep_pass1_no_twiddle",
     lambda: fourstep_vmem._filter_launches(*_planes(2, 1 << 15), *_planes(1 << 15))),
    ("fourstep_pass1_packed", "fftlab_fourstep_pass1_packed",
     lambda: fourstep_vmem.fourstep_pass1_packed(_planes(2, 1 << 16)[0])),
    ("fourstep_pass2", "fftlab_fourstep_pass2",
     lambda: fourstep_vmem.fourstep_pass2(*_planes(2, 1 << 15), 1, 0.5)),
    ("fourstep_pass2_interleaved", "fftlab_fourstep_pass2_interleaved",
     lambda: fourstep_vmem.fourstep_pass2_interleaved(*_planes(2, 1 << 15), 1, 0.5)),
    ("fourstep_pass2_unpack", "fftlab_fourstep_pass2_unpack",
     lambda: fourstep_vmem.fourstep_pass2_unpack(*_planes(2, 1 << 15), 0.5)),
    ("fourstep_pass2_sandwich", "fftlab_fourstep_pass2_sandwich",
     lambda: fourstep_vmem.fourstep_pass2_sandwich(*_planes(2, 1 << 15), *_planes(1 << 15))),
    ("threestep_pass_a", "fftlab_fourstep_pass1",
     lambda: _kernels("threestep_vmem").threestep_pass_a(*_planes(1, 1 << 21))),
    ("threestep_pass_b", "fftlab_fourstep_pass1_swap",
     lambda: _kernels("threestep_vmem").threestep_pass_b(*_planes(1, 1 << 21))),
    ("threestep_pass_c", "fftlab_fourstep_pass2",
     lambda: _kernels("threestep_vmem").threestep_pass_c(*_planes(1, 1 << 21), 1, 0.5)),
]
WRAPPER_MODULES = ("fft_vmem", "os_filter_vmem", "stft_vmem", "stage_fused", "rfft_vmem",
                   "fourstep_vmem", "threestep_vmem")


@pytest.mark.parametrize("key,entry,call", WRAPPERS, ids=[w[1][len("fftlab_"):] + "-" + w[0]
                                                          for w in WRAPPERS])
def test_every_wrapper_launches_through_the_one_path(key, entry, call, monkeypatch):
    """Each launch site on CPU tensors, with the CUDA check, the device
    guard and the stream patched and the library checking its arguments
    against SIGNATURES as ctypes does: its last launch calls its own C
    entry with the stream last, counts one under its LAUNCHES key, and
    records its span with the four PHASES back to back."""
    _fake_launch(monkeypatch)
    lib = _CheckedLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    for name in WRAPPER_MODULES:
        mod = _kernels(name)
        monkeypatch.setattr(mod, "check_cuda", lambda *tensors, name: None, raising=False)
        monkeypatch.setattr(mod, "on_cpu", lambda x, name: False, raising=False)
    counts = _kernels(next(m for m in WRAPPER_MODULES if key in _kernels(m).LAUNCHES)).LAUNCHES
    before = counts[key]
    with trace.recording():
        call()
    assert lib.calls[-1][0] == entry and lib.calls[-1][1][-1] == STREAM
    spans = trace.spans()
    roots = [i for i, s in enumerate(spans) if s[3] < 0]
    assert len(roots) == len(lib.calls) and spans[roots[-1]][0] == key
    assert counts[key] - before == sum(spans[i][0] == key for i in roots)
    last = spans[roots[-1]:]
    assert [s[0] for s in last] == [key, *trace.PHASES]
    assert last[1][1] == last[0][1] and last[-1][2] == last[0][2]
    assert all(a[2] == b[1] for a, b in zip(last[1:], last[2:]))


@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.INVERSE])
def test_a_three_pass_call_records_its_three_launches(direction, monkeypatch):
    """A recorded `plan_dft_1d_split(2^22).execute` on route `three_pass`
    (F1 = F2 = 128, F3 = 256), its launches through a library that checks
    its arguments: execute -> dispatch -> wrapper -> passes A, B and C in
    that order, each with its four PHASES; each LAUNCHES key one up; pass
    1 on its rank-1 side (L1 = 128 < STAGED_MIN_L1), so no staged twiddle
    is counted; and every check of pass B's planes inside the `checks`
    phase of pass B's span."""
    threestep_vmem = _kernels("threestep_vmem")
    _fake_launch(monkeypatch)
    lib = _CheckedLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(threestep_vmem, "on_cpu", lambda x, name: False)
    checked = []
    check_planes = fourstep_vmem.check_planes

    def planes(xr, xi, name):
        checked.append((name, trace.now()))
        check_planes(xr, xi, name)

    for mod in (fourstep_vmem, threestep_vmem):
        monkeypatch.setattr(mod, "check_planes", planes)
        monkeypatch.setattr(mod, "check_cuda",
                            lambda *tensors, name: checked.append((name, trace.now())),
                            raising=False)
    n = 1 << 22
    assert threestep_vmem._split_three(n) == (128, 128, 256)
    assert 128 < fourstep_vmem.STAGED_MIN_L1
    plan = plan_dft_1d_split(n, direction, device="cpu")
    assert plan.algorithm == "three_pass"
    before = dict(threestep_vmem.LAUNCHES)
    staged = trace.COUNTS["pass1_staged_twiddle"]
    with trace.recording():
        yr, yi = plan.execute(_pair(n, rows=1))
    assert yr.shape == yi.shape == (1, n)
    keys = ["threestep_pass_a", "threestep_pass_b", "threestep_pass_c"]
    assert {k: threestep_vmem.LAUNCHES[k] - before[k] for k in keys} == dict.fromkeys(keys, 1)
    assert trace.COUNTS["pass1_staged_twiddle"] == staged
    assert [c[0] for c in lib.calls] == ["fftlab_fourstep_pass1", "fftlab_fourstep_pass1_swap",
                                         "fftlab_fourstep_pass2"]
    spans = trace.spans()
    assert [s[0] for s in spans] == ["execute", "dispatch", "wrapper", *[
        name for key in keys for name in (key, *trace.PHASES)]]
    assert [s[3] for s in spans[:3]] == [-1, 0, 1] and len({s[4] for s in spans}) == 1
    at = {s[0]: i for i, s in enumerate(spans) if s[0] in keys}
    for key in keys:
        i = at[key]
        assert spans[i][3] == 2 and [spans[j][3] for j in range(i + 1, i + 5)] == [i] * 4
        assert spans[2][1] <= spans[i][1] <= spans[i][2] <= spans[2][2]
    assert [spans[at[k]][1] for k in keys] == sorted(spans[at[k]][1] for k in keys)
    b = at["threestep_pass_b"]
    assert spans[b + 1][0] == "checks"
    ours = [t for name, t in checked if name == "threestep_pass_b"]
    assert len(ours) == 2  # the planes, then CUDA and contiguity
    assert all(spans[b + 1][1] <= t <= spans[b + 1][2] for t in ours)
