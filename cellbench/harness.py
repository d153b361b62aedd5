"""One run of one cell: set-up, the measured window, the profiled slice
of a traced run, and the check that decides `correct`.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness reads `configs/<config>.json` (its `file`) and
`traffic/<mix>.json`, and loads by the configuration's `kind` the work
counts (`work/<kind>.py`), the plain reference (`reference/<kind>.py`)
and the entry into fftlab_torch (`program/<kind>.py`), and by each
per-layer metric's name its reader (`metrics/<name>.py`). A new cell,
mix or metric is new files and new entries, never an edit here.

Set-up: the inputs, a pool of `pool_calls` inputs of `rows` x n split
float32 planes, standard normal, drawn on the device from the seed (with
any constant of the kind, such as a filter's response, drawn first); the
entry built; three warm calls. The window then runs for `seconds`:

- `pipelined`: calls back to back, the pool read round-robin, one
  `synchronize` after the last; `gsamples_per_s` is calls x rows x n over
  the time from the first call to the return of that synchronize.
- `synced`: each call followed by `torch.cuda.synchronize()` before the
  next; each call is timed on the card by two CUDA events, one recorded
  before the entry and one after it returns, and `call_ms_p95` is the
  95th percentile of those times over every call of the window.

Every call's host time in the entry (a `perf_counter` span, without a
sync) and the kernel wrappers' LAUNCHES counters over the window are
kept for the per-layer readers. A traced run then profiles a slice of
`slice_calls` calls in the same pattern, the profiler recording the
card's operations and the harness its host spans (`trace.py`). Once the window
has closed and the peak memory is read, the outputs of `check_calls`
calls drawn from the seed over the whole window (a reservoir sample) are
compared row by row with the float64 reference (`compare.py`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from cellbench import compare
from cellbench import trace as tr

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
# Top-level modules no run may load: JAX and the JAX package.
FOREIGN = ("jax", "jaxlib", "flax", "fftlab")
WARM_CALLS = 3


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def foreign_modules(modules=None) -> list:
    """Top-level names of loaded modules that no run may load, compared
    whole (`fftlab_torch` is not `fftlab`)."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules} & set(FOREIGN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, folder: str, name: str):
    """`cellbench/<folder>/<name>.py` under `root`, found by name."""
    if not NAME.match(name):
        raise BenchError(f"{name!r} is not a name")
    path = Path(root) / "cellbench" / folder / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"cellbench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic mix
    read, and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = load_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = w["traffic"]
    if not NAME.match(traffic):
        raise BenchError(f"{traffic!r} is not a name")
    return Cell(workload, int(w["chips"]), load_json(Path(root) / entry["file"]),
                load_json(Path(root) / "cellbench" / "traffic" / f"{traffic}.json"),
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the work of one call, the card's
    peaks (None for a card peaks.json lacks), the window's calls, host
    spans (seconds) and launches by kernel, and the profiled slice."""

    work: dict
    peaks: dict | None
    calls: int
    host_s: list
    launches: dict
    slice: tr.Slice | None


class Reservoir:
    """A uniform sample of `k` of the window's calls, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, i: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, out)


def _sync(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class _Stamps:
    """The time of one call: two CUDA events on the card; on the CPU,
    where a call returns when its work is done, perf_counter."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.b.record()
        else:
            self.u = time.perf_counter()

    def ms(self) -> float:
        """After the sync that follows `stop`."""
        return self.a.elapsed_time(self.b) if self.cuda else (self.u - self.t) * 1e3


def launch_counts() -> dict:
    """The kernel wrappers' LAUNCHES counters, by kernel, summed over the
    loaded `fftlab_torch.kernels` modules."""
    out: dict = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("fftlab_torch.kernels.") and isinstance(
                getattr(mod, "LAUNCHES", None), dict):
            for k, v in mod.LAUNCHES.items():
                out[k] = out.get(k, 0) + int(v)
    return out


def _window(call, pool, seconds: float, pattern: str, device, sample: Reservoir):
    """The measured window: (calls, seconds, per-call ms of a synced mix,
    per-call host seconds in the entry)."""
    sync, stamps = _sync(device), _Stamps(device)
    lat, host = [], []
    n_pool, i = len(pool), 0
    clock = time.perf_counter
    sync()
    t0 = clock()
    end = t0 + seconds
    if pattern == "pipelined":
        while True:
            xr, xi = pool[i % n_pool]
            h = clock()
            out = call(xr, xi)
            host.append(clock() - h)
            sample.offer(i, out)
            i += 1
            if clock() >= end:
                break
        sync()
    elif pattern == "synced":
        while True:
            xr, xi = pool[i % n_pool]
            stamps.start()
            h = clock()
            out = call(xr, xi)
            host.append(clock() - h)
            stamps.stop()
            sync()
            lat.append(stamps.ms())
            sample.offer(i, out)
            i += 1
            if clock() >= end:
                break
    else:
        raise BenchError(f"unknown call pattern {pattern!r}; want pipelined or synced")
    return i, clock() - t0, lat, host


def _profiled_slice(call, pool, traffic: dict, device, log) -> tr.Slice:
    """`slice_calls` calls in the mix's pattern under torch.profiler (CUDA
    activity only), after `slice_warm_calls` that the profiler also sees
    and a sync; the harness's host spans of the slice on the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    sync, now = _sync(device), time.time_ns
    synced = traffic["pattern"] == "synced"
    n_pool, calls = len(pool), int(traffic["slice_calls"])
    acts = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    spans = []
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            for i in range(int(traffic["slice_warm_calls"])):
                call(*pool[i % n_pool])
            sync()
            t0 = now()
            for i in range(calls):
                a = now()
                xr, xi = pool[i % n_pool]
                b = now()
                out = call(xr, xi)
                c = now()
                spans += [("next_input", a, b), ("entry", b, c)]
                if synced:
                    sync()
                    spans.append(("sync", c, now()))
            if not synced:
                c = now()
                sync()
                spans.append(("sync", c, now()))
            t1 = now()
            del out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        doc = load_json(Path(path))
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        raise BenchError("the profiler's trace gives no baseTimeNanoseconds: its clock "
                         "cannot be matched to the host spans")
    us = lambda ns: tr.trace_us(ns, int(base))
    sl = tr.read_slice(doc["traceEvents"], calls, us(t0), us(t1),
                       [(name, us(a), us(b)) for name, a, b in spans])
    if sl.device_ops:
        first_entry = next(s for name, s, _ in sl.host_spans if name == "entry")
        log(f"slice: {calls} calls in {sl.window_us / 1e3:.4f} ms; the first device "
            f"operation starts {sl.device_ops[0][1] - first_entry:.1f} us after the first "
            f"entry span")
    return sl


def _card_lines(device) -> list:
    """The card's name, and its power limit where nvidia-smi reads it."""
    if device.type != "cuda":
        return [f"card: none, {device}"]
    lines = [f"card: {torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}"]
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        lines += [f"nvidia-smi: {s}" for s in p.stdout.strip().splitlines()]
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: not read ({e})")
    return lines


def _finite(x):
    return x if isinstance(x, float) and math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *,
             root: Path = ROOT, t_start: float | None = None, control: bool = False,
             log=print) -> dict:
    """One run of `workload`; returns the result's JSON object. `control`
    puts the reference's TF32 control in the program's place (the run
    that has to come out not correct). `t_start` is the process's start
    on the perf_counter clock, for `setup_s`."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    root = Path(root)
    if os.environ.get("FFTLAB_FORCE_IMPL"):
        raise BenchError("FFTLAB_FORCE_IMPL is set; the benchmark runs the routes the "
                         "program picks")
    cell = load_cell(root, workload)
    config, traffic = cell.config, cell.traffic
    kind = config["kind"]
    reference = load_module(root, "reference", kind)
    program = load_module(root, "program", kind)
    work = load_module(root, "work", kind).work(config, traffic)
    n, rows, direction = int(config["n"]), int(traffic["rows"]), traffic["direction"]
    log(f"cellbench: {workload} seed {seed} seconds {seconds} trace {int(trace)}"
        f"{' CONTROL' if control else ''}")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    consts = reference.make_constants(config, gen, device)
    shape = (int(traffic["pool_calls"]), rows, n)
    pool_r = torch.randn(shape, generator=gen, device=device)
    pool_i = torch.randn(shape, generator=gen, device=device)
    pool = [(pool_r[k], pool_i[k]) for k in range(shape[0])]
    if control:
        def call(xr, xi):
            return reference.control(xr, xi, consts, config, direction)
        route = config["route"]
    else:
        call, route = program.build(config, traffic, consts, device)
    log(f"route: {route}")
    if route != config["route"]:
        raise BenchError(f"the program took route {route!r}; {config['name']} measures "
                         f"{config['route']!r}")
    sync = _sync(device)
    for k in range(WARM_CALLS):
        call(*pool[k % len(pool)])
    sync()
    gc.collect()
    launches0 = launch_counts()
    setup_s = time.perf_counter() - t_start

    sample = Reservoir(int(traffic["check_calls"]), seed)
    calls, window_s, lat, host = _window(call, pool, seconds, traffic["pattern"], device,
                                         sample)
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()
                if v - launches0.get(k, 0)}
    log(f"window: {calls} calls in {window_s:.6f} s; launches {launches}")
    if len(lat) >= 300:  # whether the window warms up: its thirds' 95th percentiles
        k = len(lat) // 3
        log("window thirds' p95 ms: " + ", ".join(
            f"{statistics.quantiles(lat[j * k:(j + 1) * k], n=20)[18]:.5f}" for j in range(3)))
    sl = _profiled_slice(call, pool, traffic, device, log) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    for line in _card_lines(device):
        log(line)
    del call
    gc.collect()

    # the check, once the window has closed and the peak is read
    limit = float(config["contract"]["worst_row_snr_db"])
    kept = sorted(sample.kept, key=lambda kv: kv[0])
    sample.kept.clear()
    worst, failed, checked = math.inf, 0, len(kept)
    while kept:
        i, (yr, yi) = kept.pop(0)
        xr, xi = pool[i % len(pool)]
        want = reference.reference(xr, xi, consts, config, direction)
        low = min(s if s == s else -math.inf for s in compare.row_snr_db(yr, yi, want))
        worst = min(worst, low)
        failed += low < limit
        del yr, yi, want
    log(f"check: {checked} calls of {calls}, worst row SNR {worst} dB, limit {limit} dB")

    result = {"correct": failed == 0 and checked > 0, "attempted": calls, "failed": failed}
    platform = "gpu" if device.type == "cuda" else "cpu"
    dev = {"platform": platform,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if not trace:
        values = {"setup_s": setup_s,
                  "gsamples_per_s": calls * rows * n / window_s / 1e9}
        if lat:
            values["call_ms_p95"] = statistics.quantiles(lat, n=100, method="inclusive")[94]
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise BenchError(f"{m['name']} has no reading in a "
                                 f"{traffic['pattern']} mix")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        peaks = load_json(root / "cellbench" / "peaks.json").get(dev["kind"])
        record = Record(work, peaks, calls, host, launches, sl)
        for m in cell.per_layer:
            value = load_module(root, "metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if sl.device_ops:
            dev["busy_s"] = tr.busy_us(sl) * 1e-6
            dev["window_s"] = sl.window_us * 1e-6
            breakdown = {"device_ops": tr.device_ops_by_name(sl),
                         "idle_gaps": tr.idle_gaps_by_span(sl)}
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {"worst_row_snr_db": {"value": _finite(worst), "limit": limit,
                                             "rule": ">="}}
    return result


def check_lines(result: dict) -> list:
    """The numbers compared, each beside its limit: a run's last lines on
    standard error."""
    return [f"check {name}: {c['value']} {c['rule']} {c['limit']}"
            for name, c in result["checks"].items()]
