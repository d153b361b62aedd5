"""One traced cellbench run of a cell, with the numbers behind its
program-span metrics: whether fftlab_torch's spans and the profiled
slice share a clock, and where a call's host time goes.

    python3 scripts/torch_trace_clocks.py --workload c2c_1m.bulk16 --seed 2147500001

Runs the cell as `cellbench/run.py --trace 1` does (on the card, the
window of `--seconds`, then the slice under torch.profiler), and prints
one JSON line: the result's metrics; the base interval's width (ns);
how many `execute` roots lie inside their `entry` spans (all of them,
where the base is placed); whether the device operations pair with the
launches by count and name; the median `entry` span beside
`host_path_us.bulk`; the median self time a call of each span name
(execute, dispatch, wrapper, each kernel, checks, alloc, tables, call)
and their sum beside the median root; the gaps the card waited on the
host in (how many, the five largest as [us, k, the gap's us]) and where
the first operation and the first `call` span end fall after the slice's
start; the set-up spans by name; and `setup_s` (the process's start to
the end of the warm calls).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def self_times(spans: list, ids: set) -> dict:
    """{span name: [self time (us) a call]} over the calls `ids`."""
    calls: dict = {}
    cover = [0] * len(spans)
    for name, s, e, parent, call in spans:
        if parent >= 0:
            cover[parent] += e - s
    for i, (name, s, e, parent, call) in enumerate(spans):
        if call in ids:
            mine = calls.setdefault(call, {})
            mine[name] = mine.get(name, 0.0) + (e - s - cover[i]) / 1e3
    names = sorted({n for c in calls.values() for n in c})
    return {n: [c.get(n, 0.0) for c in calls.values()] for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import fftlab_torch  # noqa: F401
    from cellbench import harness, program_spans
    from fftlab_torch.utils import trace

    seen = {}
    make_record, make_reservoir = harness.Record, harness.Reservoir

    def record(*a):
        seen["record"] = make_record(*a)
        return seen["record"]

    def reservoir(*a):  # made right after the harness reads setup_s
        seen.setdefault("setup_s", time.perf_counter() - T_START)
        return make_reservoir(*a)

    harness.Record, harness.Reservoir = record, reservoir
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              torch.device("cuda", 0), t_start=T_START,
                              log=lambda s: print(s, file=sys.stderr, flush=True))
    rec = seen["record"]
    sl = rec.slice
    ps = program_spans.read(rec)
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"]["kind"], "setup_s": seen["setup_s"]}
    entries = [e - s for name, s, e in sl.host_spans if name == "entry"]
    out["entry_us_median"] = statistics.median(entries)
    if ps is not None:
        inside = sum(a <= s and e <= b for (s, e), (_, a, b) in
                     zip(ps.roots, [h for h in sl.host_spans if h[0] == "entry"]))
        pairs = len(sl.device_ops) == len(ps.launches) and all(
            n.startswith(ln.kernel) for (n, _, _), ln in zip(sl.device_ops, ps.launches))
        st = self_times(trace.spans(), set(ps.ids))
        parts, free = [], sl.t0  # the host-bound part of each gap, as the reader sums it
        for k, ((_, a, b), ln) in enumerate(zip(sl.device_ops, ps.launches)):
            if a > free and min(a, ln.call_end) > free:
                parts.append((min(a, ln.call_end) - free, k, a - free))
            free = max(free, b)
        first = ps.launches[0] if ps.launches else None
        out.update(host_bound_gaps=len(parts),
                   host_bound_top=[[round(x, 3), k, round(g, 3)] for x, k, g in
                                   sorted(parts, reverse=True)[:5]],
                   first_op_after_t0_us=sl.device_ops[0][1] - sl.t0 if sl.device_ops else None,
                   first_call_end_after_t0_us=first.call_end - sl.t0 if first else None)
        out.update(base_width_ns=ps.base_width_ns, roots=len(ps.roots),
                   roots_inside_entry=inside, ops=len(sl.device_ops),
                   launches=len(ps.launches), ops_pair_with_launches=pairs,
                   self_us_median={n: statistics.median(v) for n, v in st.items()},
                   self_us_sum_median=statistics.median(
                       [sum(v[k] for v in st.values()) for k in range(len(ps.ids))]),
                   root_us_median=statistics.median([e - s for s, e in ps.roots]))
    else:  # why there is no reading: the interval the last roots give
        roots = sorted((s, e) for name, s, e, parent, call in trace.spans()
                       if parent < 0 and name == program_spans.ROOT and e > 0)
        hosts = sorted((s, e) for name, s, e in sl.host_spans if name == "entry")
        if hosts and len(roots) >= len(hosts):
            lo, hi = program_spans.base_interval(roots[-len(hosts):], hosts)
            out.update(no_reading=True, base_lo_ns=lo, base_hi_ns=hi, roots=len(roots))
    setup: dict = {}
    for name, s, e, parent, call in trace.setup_spans():
        key = name if not name.startswith("table.") else "table"
        setup[key] = setup.get(key, 0.0) + (e - s) * 1e-9
    out["setup_spans_s"] = setup
    out["counts"] = {k: v for k, v in trace.COUNTS.items() if v}
    print(json.dumps(out), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
