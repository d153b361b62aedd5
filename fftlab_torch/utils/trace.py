"""Timing spans, the program's span recorder and profiler traces
(counterpart of fftlab/utils/trace.py).

`Timer` accumulates start/stop laps. `span` times a block into a dict of
timers on the host's clock and, before it reads the clock at the end,
waits for the card (`torch.cuda.synchronize`), so the span holds the work
the block enqueued, not only its launch. `profiler_trace` records a
`torch.profiler` trace (CPU and, where there is a card, CUDA activity)
and writes it as a Chrome trace into `log_dir`; `annotate` marks a range
inside it. For kernel times use CUDA events (`bench/timing.py`).

The recorder
------------
fftlab_torch records spans inside its own host path, in memory, on the
wall clock `time.time_ns()`: the clock of torch's Chrome trace, less the
trace's `baseTimeNanoseconds`. It records only while it is on:

- while a `torch.profiler` profile runs, whatever its activities, so an
  application profiled with `torch.profiler` gets fftlab's spans with it;
- inside `with recording():`.

Off, each site reads one flag (`on()`): no clock, no allocation.

    with trace.recording():
        plan.execute((xr, xi))
    for name, start_ns, end_ns, parent, call in trace.spans(): ...
    trace.clear()

`spans()` returns the recorded spans, oldest first. `parent` is the index
in that list of the span that encloses it (-1 for a root); a root starts
a new `call` id, which every span under it shares. The spans of a call:

    execute        the root: Plan.execute, spectral_filter_auto,
                   fft_split_auto (a public call inside another is a child)
      dispatch     route selection and the branch to the route (a fused
                   r2c/c2r plan chose its route when it was made: no
                   dispatch, its `wrapper` is right under `execute`)
        wrapper    the route's entry: reshapes, plane checks, the response
                   planes, the scale
          <kernel> one a launch, named by its LAUNCHES key, with children
            checks the launch's checks and sides
            alloc  the torch.empty calls
            tables the cached tables, the launch geometry and the
                   argument tuple
            call   kernels/_build.launch: the device guard, the stream,
                   the ctypes entry, its error check and the count

Every launch records all four phases: its wrapper takes `mark =
phases()` at its start and calls `mark()` at the start of alloc and of
tables (`mark(2)` where it allocates nothing), `kernels/_build.launch`
at the start of call. Off, `phases()` is OFF, a builtin: no clock, no
Python frame. A `span` block records too while the recorder is on. The
buffer keeps CAPACITY records (a launch and its children are one); past
that, spans are dropped and counted. `clear()` empties it.

Set-up spans are recorded whether or not the recorder is on, since each
happens once a process or a shape, in their own list (`setup_spans()`,
same fields): `import` (fftlab_torch/__init__.py, top to bottom),
`library` (kernels/_build.load_library; children `digest`, `build` when
nvcc runs, `dlopen`), `table.<module>.<function>` (a miss of a cached
table function of kernels/, `table_cache`) and `plan` (the plan_* constructors).

`COUNTS` holds cumulative counters, like the kernels' LAUNCHES:
`library_builds`, `library_loads`, `table_builds.<module>.<function>` and
`spans_dropped`.

`profiler_trace` appends the spans recorded in its block to the
trace.json it writes, as complete events of a process named `fftlab`, on
that file's clock, so Perfetto shows them over the kernels.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"
# Records the recorder keeps before it drops: hot path, set-up.
CAPACITY = 1 << 18
SETUP_CAPACITY = 1 << 12
# The children of a kernel launch span, in order.
PHASES = ("checks", "alloc", "tables", "call")
COUNTS = {"library_builds": 0, "library_loads": 0, "spans_dropped": 0}

now = time.time_ns

# A span is [name, start, end, parent, call, index in its list], and a
# launch's the starts of its PHASES besides (`launch`).
_spans: list = []
_setup: list = []
_call_ids = itertools.count()
_recording = 0
_profiler = torch.autograd.profiler

# Whether a torch.profiler profile runs, read in C (no Python frame): torch's
# own Python flag where it has one, else its C query.
if hasattr(_profiler, "_is_profiler_enabled"):
    _profiling = functools.partial(getattr, _profiler, "_is_profiler_enabled")
else:
    _profiling = torch._C._autograd._profiler_enabled
_always = True.__bool__

# on() -> whether the recorder records: while a profile runs, or inside
# `recording()`, which swaps in `_always`. Sites call it as `trace.on()`.
on = _profiling


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the block."""
    global _recording, on
    _recording += 1
    on = _always
    try:
        yield
    finally:
        _recording -= 1
        if not _recording:
            on = _profiling


class _Open(threading.local):
    """This thread's open spans: of the hot path and of set-up."""

    def __init__(self):
        self.spans = []
        self.setup = []


_open = _Open()


def _under(spans: list, stack: list) -> tuple[int, int]:
    """(parent, call) of a span opened now: the innermost open span of
    `stack` that `spans` still holds, else a root with a new call id."""
    if stack:
        p = stack[-1]
        if p[5] < len(spans) and spans[p[5]] is p:
            return p[5], p[4]
    return -1, next(_call_ids)


def _begin(spans: list, capacity: int, stack: list, name: str, start: int):
    """Append the span `name` from `start` to `spans` and open it on
    `stack`; None, counted as dropped, once `spans` holds `capacity`."""
    if len(spans) >= capacity:
        COUNTS["spans_dropped"] += 1
        return None
    rec = [name, start, 0, *_under(spans, stack), len(spans)]
    spans.append(rec)
    stack.append(rec)
    return rec


def _end(stack: list, rec) -> None:
    """Close `rec` (a `_begin` result, None for a dropped span) now."""
    if rec is not None:
        if stack and stack[-1] is rec:
            stack.pop()
        rec[2] = now()


def begin(name: str):
    """Open the span `name` now; for a site that has found `on()` true.
    Returns the handle `end` takes. `_begin` written out: a root's stamps
    lie as near its caller's as they can, which places the spans on a
    trace's clock (cellbench/program_spans.py)."""
    start = now()
    spans, stack = _spans, _open.spans
    if len(spans) >= CAPACITY:
        COUNTS["spans_dropped"] += 1
        return None
    rec = [name, start, 0, *_under(spans, stack), len(spans)]
    spans.append(rec)
    stack.append(rec)
    return rec


def end(rec) -> None:
    """Close a span that `begin` opened (`_end` written out, as in
    `begin`)."""
    if rec is not None:
        stack = _open.spans
        if stack and stack[-1] is rec:
            stack.pop()
        rec[2] = now()


# A launch's phase marker while the recorder is off: a builtin that takes
# what a mark takes, called in C.
OFF = bool


class Phases(list):
    """The starts of a launch's PHASES; its bound `mark` is the marker."""

    __slots__ = ()

    def mark(self, n: int = 1) -> None:
        """Start the next phase now (n > 1: n phases, n - 1 of zero length)."""
        self.append(now())
        if n > 1:
            self.extend(self[-1:] * (n - 1))


def phases():
    """A launch's phase marker for `kernels/_build.launch`: while the
    recorder is on, `Phases.mark` of starts from now, else OFF (no clock)."""
    return Phases((now(),)).mark if on() else OFF


def launch(name: str, mark) -> None:
    """Record the launch of kernel `name` (its LAUNCHES key), PHASES[i] from
    start i of `mark` (`phases()`): one record, the starts a tuple (gc skips it)."""
    starts = mark.__self__
    spans = _spans
    if len(spans) >= CAPACITY:
        COUNTS["spans_dropped"] += 1 + len(PHASES)
        return
    spans.append([name, starts[0], now(), *_under(spans, _open.spans), len(spans),
                  tuple(starts)])


def _rebuilt(records: list) -> list:
    """The spans (name, start, end, parent, call) of `records`, each launch
    record's children right after it, parents as indices into the list
    returned."""
    out, at = [], {}
    for rec in records:
        name, start, end, parent, call, index = rec[:6]
        at[index] = len(out)
        out.append((name, start, end, at.get(parent, -1), call))
        if len(rec) > 6:
            starts = rec[6]
            out += [(child, a, b, at[index], call) for child, a, b in
                    zip(PHASES, starts, (*starts[1:], end))]
    return out


def spans() -> list:
    """The recorded spans, oldest first: (name, start_ns, end_ns, parent,
    call), end 0 while a span is open."""
    return _rebuilt(_spans)


def clear() -> None:
    """Empty the span buffer; spans still open are not recorded."""
    _spans.clear()


def setup_begin(name: str, start: int | None = None):
    """Open the set-up span `name`, from `start` (a `now()` stamp) or now."""
    return _begin(_setup, SETUP_CAPACITY, _open.setup, name,
                  now() if start is None else start)


def setup_end(rec) -> None:
    """Close a set-up span that `setup_begin` opened."""
    _end(_open.setup, rec)


@contextlib.contextmanager
def setup_span(name: str):
    """The set-up span `name` over the block, or over a function it
    decorates."""
    rec = setup_begin(name)
    try:
        yield
    finally:
        setup_end(rec)


def setup_spans() -> list:
    """The set-up spans, oldest first, in the fields of `spans()`."""
    return _rebuilt(_setup)


def table_cache(maxsize: int):
    """`functools.lru_cache(maxsize=maxsize)` for a table function of
    kernels/: on a miss its body runs as the set-up span
    `table.<module>.<function>` and counts one into
    COUNTS["table_builds.<module>.<function>"]; a hit reaches neither."""
    def wrap(fn):
        table = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"
        key = f"table_builds.{table}"
        COUNTS.setdefault(key, 0)

        @functools.wraps(fn)
        def build(*args, **kwargs):
            COUNTS[key] += 1
            with setup_span(f"table.{table}"):
                return fn(*args, **kwargs)

        return functools.lru_cache(maxsize=maxsize)(build)

    return wrap


@dataclass
class Timer:
    """A start/stop/elapsed_ms timer that accumulates across cycles."""

    _t0: float = 0.0
    total_s: float = 0.0
    laps: list = field(default_factory=list)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.laps.append(dt)
        return dt

    @property
    def elapsed_ms(self) -> float:
        return self.total_s * 1e3


def _sync_device(device) -> torch.device | None:
    """The CUDA device a span waits for: `device` if it is one, the current
    card when `device` is None and there is a card, else None (a CPU
    op's work is done when it returns)."""
    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


@contextlib.contextmanager
def span(name: str, timers: dict | None = None, sync: bool = True, device=None):
    """Time the block into `timers[name]` (a `Timer`, made on first use).
    With `sync`, the end waits for `device`'s queue
    (`torch.cuda.synchronize(device)`; by default the current card where
    there is one) before reading the clock. While the recorder is on, the
    block is also the recorder's span `name`, ending where the timer reads
    the clock. With no `timers` and the recorder off, it does nothing: no
    wait, no clock."""
    rec = begin(name) if on() else None
    if timers is None:
        try:
            yield
        finally:
            end(rec)
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dev = _sync_device(device) if sync else None
        if dev is not None:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        end(rec)
        timers.setdefault(name, Timer()).laps.append(dt)
        timers[name].total_s += dt


def _merge_spans(path: str, t0: int, t1: int) -> None:
    """Append the spans recorded within [t0, t1] (`now()` stamps) to the
    Chrome trace at `path`, as complete events of a process `fftlab` on
    the trace's clock (its `baseTimeNanoseconds`): the host path on one
    row, set-up on another. A trace with no base is left as it is."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        return
    events = doc.setdefault("traceEvents", [])
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "fftlab"}})
    for tid, (row, recs) in enumerate((("host path", spans()),
                                       ("set-up", setup_spans())), 1):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": row}})
        events += [{"ph": "X", "cat": "fftlab", "name": name, "pid": pid, "tid": tid,
                    "ts": (s - int(base)) / 1e3, "dur": (e - s) / 1e3,
                    "args": {"parent": parent, "call": call}}
                   for name, s, e, parent, call in recs if t0 <= s and 0 < e <= t1]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Record a `torch.profiler` trace of the block (CPU activity, and CUDA
    activity where there is a card) and write it to
    `log_dir/trace.json`, viewable in Perfetto or chrome://tracing, with
    fftlab's spans of the block merged in. Yields the profiler, whose
    `key_averages()` sum the recorded ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = now()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    t1 = now()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _merge_spans(path, t0, t1)


def annotate(name: str):
    """A named range inside a profiler trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
