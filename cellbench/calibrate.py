#!/usr/bin/env python3
"""The readings a cell's limit of `correct` is set from, in one process
on the card:

    python3 cellbench/calibrate.py --workload <cell> --seconds 1 \\
        --seeds <12 or more> --control-seeds <3 or more>

Each seed is a run of the harness at the cell's own size and load (a
short window, the same sample of calls checked as a full run checks):
with `--seeds` the program, with `--control-seeds` the control, the
reference's TF32 transform put in the program's place. Prints one JSON
line a run (the worst row's SNR and whether it was correct), then the
lower reading (the program's worst over its seeds) and the upper reading
(the control's best over its seeds). The benchmark's own runs never run
the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cellbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    readings = {False: [], True: []}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            r = harness.run_cell(args.workload, seed, args.seconds, False, args.device,
                                 control=control, log=lambda s: None)
            snr = r["checks"]["worst_row_snr_db"]["value"]
            readings[control].append(snr)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "worst_row_snr_db": snr, "correct": r["correct"],
                              "attempted": r["attempted"], "metrics": r["metrics"]}),
                  flush=True)
    prog = [s for s in readings[False] if s is not None]
    ctrl = [s for s in readings[True] if s is not None]
    print(json.dumps({"workload": args.workload,
                      "program_seeds": len(readings[False]),
                      "program_worst_db": min(prog) if prog else None,
                      "program_best_db": max(prog) if prog else None,
                      "control_seeds": len(readings[True]),
                      "control_best_db": max(ctrl) if ctrl else None,
                      "control_worst_db": min(ctrl) if ctrl else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
