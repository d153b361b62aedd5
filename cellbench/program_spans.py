"""The program's own spans, placed on the profiled slice's clock.

fftlab_torch records spans inside its host path while a torch.profiler
profile runs, so during a traced run's slice (its recorder,
`fftlab_torch.utils.trace`): a root `execute` a call, and under it a span
a kernel launch, named by the kernel's LAUNCHES key, whose child `call`
covers the ctypes entry. Its set-up spans (`import`, `library`,
`table.<module>.<function>`, `plan`) are kept whether it records or not. This
module finds the recorder in `sys.modules`, as `harness.launch_counts`
finds LAUNCHES, and imports nothing of the program: a program without
the recorder gives no reading.

The recorder stamps `time.time_ns()`; the slice is in microseconds less
the trace's `baseTimeNanoseconds`, which a reader is not given. Each
call's `execute` root lies inside the harness's `entry` span of the same
call, so each pair bounds the base from both sides; `program_slice`
pairs the last roots with the slice's entry spans in order, and gives
nothing where the bounds cross (the clocks disagree), are wider than
MAX_BASE_WIDTH_NS, or the roots at or after the slice's start are not
its calls (the roots of its warm calls fall before it).
"""

from __future__ import annotations

import dataclasses
import statistics
import sys

RECORDER = "fftlab_torch.utils.trace"
ROOT = "execute"
CALL = "call"
MAX_BASE_WIDTH_NS = 2000.0


@dataclasses.dataclass
class Launch:
    """A kernel launch of the slice, in trace microseconds: its call (the
    index of its root among the slice's calls), its kernel (LAUNCHES key),
    its span and its `call` child."""

    call: int
    kernel: str
    start: float
    end: float
    call_start: float
    call_end: float


@dataclasses.dataclass
class ProgramSlice:
    """The program's spans of the profiled slice on its clock: the
    `execute` roots (start, end) of its calls in order, their call ids,
    its launches in order of start, the width of the interval the base
    was placed in (ns), and the base as an offset (ns) from the first
    paired root's start."""

    roots: list
    ids: list
    launches: list
    base_width_ns: float
    base_offset_ns: float

    def per_call(self, value) -> list:
        """[sum of value(launch) over each call's launches] a call."""
        out = [0.0] * len(self.roots)
        for ln in self.launches:
            out[ln.call] += value(ln)
        return out


def recorder():
    """The program's recorder module where it is loaded and has one."""
    mod = sys.modules.get(RECORDER)
    if mod is None or not callable(getattr(mod, "spans", None)):
        return None
    return mod


def base_interval(roots: list, entries: list):
    """The interval (lo, hi) of the base, in ns after roots[0]'s start,
    that puts every root (start_ns, end_ns) inside its entry span
    (start_us, end_us) on the trace's clock."""
    ref = roots[0][0]
    lo = max(e - ref - b * 1e3 for (_, e), (_, b) in zip(roots, entries))
    hi = min(s - ref - a * 1e3 for (s, _), (a, _) in zip(roots, entries))
    return lo, hi


def program_slice(sl, spans: list) -> ProgramSlice | None:
    """The recorder's `spans` (name, start_ns, end_ns, parent, call) of the
    slice `sl` (cellbench.trace.Slice) on its clock, or None (see the
    module's docstring)."""
    entries = sorted((s, e) for name, s, e in sl.host_spans if name == "entry")
    roots = sorted(((s, e, call) for name, s, e, parent, call in spans
                    if parent < 0 and name == ROOT and e > 0), key=lambda r: r[0])
    if not entries or len(roots) < len(entries):
        return None
    lo, hi = base_interval([r[:2] for r in roots[-len(entries):]], entries)
    if lo > hi or hi - lo > MAX_BASE_WIDTH_NS:
        return None
    ref, off = roots[-len(entries)][0], 0.5 * (lo + hi)
    us = lambda ns: (ns - ref - off) / 1e3  # noqa: E731
    inside = [r for r in roots if us(r[0]) >= sl.t0]
    if len(inside) != sl.calls:
        return None
    index = {r[2]: k for k, r in enumerate(inside)}
    launches = []
    for name, s, e, parent, call in spans:
        if name == CALL and call in index and parent >= 0:
            kernel, ks, ke = spans[parent][:3]
            launches.append(Launch(index[call], kernel, us(ks), us(ke), us(s), us(e)))
    launches.sort(key=lambda ln: ln.start)
    return ProgramSlice([(us(s), us(e)) for s, e, _ in inside], [r[2] for r in inside],
                        launches, hi - lo, off)


def read(record) -> ProgramSlice | None:
    """`program_slice` of a Record's slice with the loaded recorder."""
    mod = recorder()
    if record.slice is None or mod is None:
        return None
    return program_slice(record.slice, mod.spans())


def median(values: list):
    return statistics.median(values) if values else None


def host_bound_idle_us(sl, launches: list) -> float | None:
    """Microseconds of the slice in which the card was idle waiting for a
    kernel the host had not launched yet: of the gap before the slice's
    k-th device operation, the part before the end of its k-th `call`
    span. None unless the operations and the launches pair by order and
    each operation's name starts with its launch's kernel."""
    ops = sl.device_ops
    if not ops or len(ops) != len(launches):
        return None
    if any(not name.startswith(ln.kernel) for (name, _, _), ln in zip(ops, launches)):
        return None
    total, free = 0.0, sl.t0
    for (_, s, f), ln in zip(ops, launches):
        if s > free:
            total += max(0.0, min(s, ln.call_end) - free)
        free = max(free, f)
    return total


def setup_roots_s(spans: list) -> float | None:
    """The set-up spans with no set-up parent, closed, summed, in seconds."""
    roots = [(e - s) * 1e-9 for name, s, e, parent, call in spans if parent < 0 and e > 0]
    return sum(roots) if roots else None
