"""Timing spans and profiler traces (counterpart of
fftlab/utils/trace.py).

`Timer` accumulates start/stop laps. `span` times a block on the host's
clock and, before it reads the clock at the end, waits for the card
(`torch.cuda.synchronize`), so the span holds the work the block
enqueued, not only its launch. `profiler_trace` records a
`torch.profiler` trace (CPU and, where there is a card, CUDA activity)
and writes it as a Chrome trace into `log_dir`; `annotate` marks a range
inside it. For kernel times use CUDA events (`bench/timing.py`): a span
is one wall-clock reading, launch and host time included.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"


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
    there is one) before reading the clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dev = _sync_device(device) if sync else None
        if dev is not None:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if timers is not None:
            timers.setdefault(name, Timer()).laps.append(dt)
            timers[name].total_s += dt


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Record a `torch.profiler` trace of the block (CPU activity, and CUDA
    activity where there is a card) and write it to
    `log_dir/trace.json`, viewable in Perfetto or chrome://tracing. Yields
    the profiler, whose `key_averages()` sum the recorded ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named range inside a profiler trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
