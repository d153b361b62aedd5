#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Earlier lines name the cell, the route the
program took and the card; the last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and `checks` last: each number compared beside
its limit), and the last lines of standard error repeat the checks.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics. Exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell asks for), without the fftlab_torch of
this checkout, or when the run has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from cellbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cellbench: {args.workload} needs {cell.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    import fftlab_torch

    if Path(fftlab_torch.__file__).resolve().parent != ROOT / "fftlab_torch":
        print(f"cellbench: fftlab_torch comes from {fftlab_torch.__file__}, not from this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T_START,
                              log=lambda s: print(s, flush=True))
    found = harness.foreign_modules()
    if found:
        print(f"cellbench: the run loaded {', '.join(found)}; no run may load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
