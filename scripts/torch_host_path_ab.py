"""The host path of fftlab_torch's two bulk entries in two source trees,
in one process on one CUDA card, in turns: the recorder's cost, off and
on.

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python3 scripts/torch_host_path_ab.py _parent . --rounds 600

Each tree's fftlab_torch is imported in turn into this process and its
modules kept; before each batch the batch's tree goes back into
`sys.modules`, so the imports inside its functions find its own modules
(and its own kernel library). A batch makes 64 calls of an entry at the
benchmark's bulk16 shape, 16 x 2^20 (`plan_dft_1d_split(2**20).execute`
and `spectral_filter_auto`), with a sync after every 8 so that the
card's queue never fills and holds a launch back, and reads each call's
host time as cellbench's window does (perf_counter around the call); its
median is the batch's. Two runs of rounds: the two trees with the
recorder off, then, where the second tree has a recorder, that tree
with it off and under `utils.trace.recording()` (apart, so that the
spans it keeps and frees are not left to the batches that compare the
trees). Each round runs both variants, in an order that turns around
from round to round. Prints one JSON line: the card and its power
limit, and for each entry and run the two variants' medians over the
rounds and the quartiles of each round's difference (second less first,
on less off), and the cost of one `trace.on()` read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

import torch

N, ROWS, CALLS, EVERY = 1 << 20, 16, 64, 8


def _drop_package():
    for name in [m for m in sys.modules if m == "fftlab_torch" or m.startswith("fftlab_torch.")]:
        del sys.modules[name]


def load(tree: str, xr, xi, hr, hi) -> dict:
    """The tree's modules and entries, each entry called three times."""
    _drop_package()
    path = os.path.abspath(tree)
    sys.path.insert(0, path)
    try:
        import fftlab_torch
        from fftlab_torch.plan.api import plan_dft_1d_split
        from fftlab_torch.plan.dispatch import spectral_filter_auto
    finally:
        sys.path.remove(path)
    if not os.path.abspath(fftlab_torch.__file__).startswith(path + os.sep):
        raise RuntimeError(f"fftlab_torch came from {fftlab_torch.__file__}, not {path}")
    execute = plan_dft_1d_split(N).execute
    entries = {"c2c": lambda: execute((xr, xi)),
               "filter": lambda: spectral_filter_auto(xr, xi, hr, hi)}
    for call in entries.values():
        for _ in range(3):
            call()
    torch.cuda.synchronize()
    trace = sys.modules.get("fftlab_torch.utils.trace")
    return {"modules": {k: v for k, v in sys.modules.items()
                        if k == "fftlab_torch" or k.startswith("fftlab_torch.")},
            "entries": entries, "trace": trace,
            "recording": getattr(trace, "recording", None)}


def batch(call) -> float:
    """The median host time (us) of CALLS calls, a sync after every EVERY."""
    times = []
    clock = time.perf_counter
    for i in range(CALLS):
        t = clock()
        call()
        times.append(clock() - t)
        if (i + 1) % EVERY == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def quartiles(values: list) -> list:
    return statistics.quantiles(values, n=4) if len(values) > 1 else values * 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first", help="the tree compared against (the parent)")
    ap.add_argument("second", help="the tree measured (the change)")
    ap.add_argument("--rounds", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_host_path_ab: needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(2**31 + 17)
    xr, xi = (torch.randn(ROWS, N, generator=g, device="cuda") for _ in range(2))
    hr, hi = (torch.randn(N, generator=g, device="cuda") / 2 for _ in range(2))
    trees = {"first": load(args.first, xr, xi, hr, hi),
             "second": load(args.second, xr, xi, hr, hi)}
    names = list(trees["first"]["entries"])
    out = {"card": torch.cuda.get_device_name(0), "rounds": args.rounds,
           "calls_a_batch": CALLS, "first": args.first, "second": args.second}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"not read ({e})"
    phases = [("first", "second", False)]  # (base, measured, the recorder on)
    if trees["second"]["recording"] is not None:
        phases.append(("second", "second", True))
    for base, measured, on in phases:
        variants = [(base, False), (measured, on)]
        reads = {(v, e): [] for v in variants for e in names}
        for r in range(args.rounds):
            for tree, rec in (variants if r % 2 == 0 else variants[::-1]):
                t = trees[tree]
                _drop_package()
                sys.modules.update(t["modules"])
                with (t["recording"]() if rec else contextlib.nullcontext()):
                    for entry, call in t["entries"].items():
                        reads[((tree, rec), entry)].append(batch(call))
                if rec:
                    t["trace"].clear()
        tag = "recording_minus_off" if on else "second_minus_first"
        for entry in names:
            a, b = reads[(variants[1], entry)], reads[(variants[0], entry)]
            out[f"{entry}.{tag}.medians_us"] = [statistics.median(b), statistics.median(a)]
            out[f"{entry}.{tag}.us_quartiles"] = quartiles([x - y for x, y in zip(a, b)])
    trace = trees["second"]["trace"]
    if trace is not None and hasattr(trace, "on"):
        n = 1_000_000
        out["trace_on_read_ns"] = min(timeit.repeat(trace.on, number=n, repeat=5)) / n * 1e9
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
