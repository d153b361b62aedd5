"""Reading the profiled slice of a traced run.

The slice is a Chrome trace of `torch.profiler` with CUDA activity only,
so the profiler adds little to the host's time a call. The harness
keeps its own host spans of the slice (`next_input`, `entry` and, in a
synced mix, `sync` a call; one `sync` at the end of a pipelined slice)
on the wall clock, `time.time_ns()`, which the trace's clock is, less
its `baseTimeNanoseconds`. Times here are microseconds on the trace's
clock.
"""

from __future__ import annotations

import dataclasses

# Trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Slice:
    """The profiled slice: its bounds, the calls made in it, the device's
    operations (name, start, end) and the harness's host spans (name,
    start, end)."""

    t0: float
    t1: float
    calls: int
    device_ops: list
    host_spans: list

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0


def short_kernel_name(name: str) -> str:
    """`void ns::fourstep_pass1_kernel<0, 10>(float const*, ...)` ->
    `fourstep_pass1_kernel<0, 10>`: no return type, namespace or argument
    list; the template arguments stay. A name that is no kernel's
    signature (`Memcpy DtoD (Device -> Device)`) stays as it is."""
    name = name.strip()
    if not name.startswith("void "):
        return name
    if name.endswith(")"):  # drop the argument list: the last top-level (...)
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.removeprefix("void ").strip()
    depth, cut = 0, 0
    for i, c in enumerate(name):
        depth += {"<": 1, ">": -1}.get(c, 0)
        if depth == 0 and name.startswith("::", i):
            cut = i + 2
    return name[cut:]


def trace_us(wall_ns: int, base_ns: int) -> float:
    """A `time.time_ns()` reading on the trace's clock."""
    return (wall_ns - base_ns) / 1e3


def read_slice(events: list, calls: int, t0: float, t1: float, host_spans: list) -> Slice:
    """The slice [t0, t1) (trace microseconds) from a Chrome trace's
    `traceEvents`: the device's operations that overlap it, and the
    harness's host spans (name, start, end) of it."""
    ops = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        f = s + float(e["dur"])
        if f > t0 and s < t1:
            ops.append((short_kernel_name(e["name"]), s, f))
    return Slice(t0, t1, calls, sorted(ops, key=lambda o: o[1]),
                 sorted(host_spans, key=lambda o: o[1]))


def busy_intervals(sl: Slice) -> list:
    """The union of the device's operations, clipped to the slice, as
    sorted disjoint (start, end) intervals."""
    out = []
    for _, s, f in sorted(sl.device_ops, key=lambda o: o[1]):
        s, f = max(s, sl.t0), min(f, sl.t1)
        if f <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], f)
        else:
            out.append([s, f])
    return [tuple(iv) for iv in out]


def busy_us(sl: Slice) -> float:
    """Microseconds of the slice in which some operation ran on the device."""
    return sum(f - s for s, f in busy_intervals(sl))


def idle_share(sl: Slice) -> float | None:
    """The share of the slice in which nothing ran on the device; None
    where the trace holds no device operation."""
    if not sl.device_ops or sl.window_us <= 0:
        return None
    return 1.0 - busy_us(sl) / sl.window_us


def device_us_per_call(sl: Slice) -> float | None:
    """The device operations' summed time over the calls in the slice."""
    if not sl.device_ops or sl.calls <= 0:
        return None
    return sum(f - s for _, s, f in sl.device_ops) / sl.calls


def device_ops_by_name(sl: Slice, top: int = 10) -> list:
    """[[name, seconds]] of the device's operations summed by name, most
    first."""
    tot: dict = {}
    for name, s, f in sl.device_ops:
        tot[name] = tot.get(name, 0.0) + (f - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(sl: Slice) -> list:
    """(start, end) of each stretch of the slice in which the device ran
    nothing."""
    gaps, t = [], sl.t0
    for s, f in busy_intervals(sl):
        if s > t:
            gaps.append((t, s))
        t = max(t, f)
    if sl.t1 > t:
        gaps.append((t, sl.t1))
    return gaps


def host_span_at(sl: Slice, t: float) -> str:
    """The harness's host span open at time t, or `other`."""
    for name, s, f in sl.host_spans:
        if s <= t < f:
            return name
    return "other"


def idle_gaps_by_span(sl: Slice, top: int = 10) -> list:
    """[[span, seconds]]: the device's idle time in the slice, summed by
    the host span open at each gap's midpoint, most first."""
    if not sl.device_ops:
        return []
    tot: dict = {}
    for s, f in idle_gaps(sl):
        name = host_span_at(sl, 0.5 * (s + f))
        tot[name] = tot.get(name, 0.0) + (f - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
