"""Time pass 1 at every two-pass size, and the three-pass FFT's passes A and
B at 2^22..2^26, in two or more source trees on one CUDA card, in turns.

Run from the root of a checkout, with the other tree unpacked beside it
(for example the parent commit: `mkdir -p _parent && git archive <commit>
| tar -x -C _parent`):

    python3 scripts/torch_pass1_sweep.py _parent .

Each tree runs in its own process, which puts the tree first on the import
path and builds its kernels from its own sources; the processes run in
turns (t1 t2 ... t2 t1). Every case moves 2^24 points (batch 2^24/n, at
least 1) and is timed as a CUDA graph of 10 calls (chip_smoke.py's
`time_ms(graph=True)`: the device time alone). The script prints one
`sweep` line a case, each tree's runs, their mean and the ratio to the
first tree's, beside the card's name and power limit. Its readings chose
the shortest L1 whose pass 1 stages its twiddle table in shared memory
(kernels/fourstep_vmem.py STAGED_MIN_L1; PERF.md §6).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 1 << 24


def worker(tree: str) -> dict:
    """The cases' device times in `tree`, in ms a call."""
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms  # this checkout's, before `tree` goes on the path

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from fftlab_torch.kernels import _build, fourstep_vmem, threestep_vmem

    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def planes(n):
        shape = (max(1, POINTS // n), n)
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    out = {}
    for e in range(15, 22):
        xr, xi = planes(1 << e)
        L1 = fourstep_vmem._split_sides(1 << e)[0]
        out[f"pass1 2^{e} L1={L1}"] = time_ms(lambda: fourstep_vmem.fourstep_pass1(xr, xi),
                                              graph=True)
    for e in range(22, 27):
        xr, xi = planes(1 << e)
        sides = threestep_vmem._split_three(1 << e)
        a = threestep_vmem.threestep_pass_a(xr, xi)
        out[f"pass_a 2^{e} {sides}"] = time_ms(lambda: threestep_vmem.threestep_pass_a(xr, xi),
                                               graph=True)
        out[f"pass_b 2^{e} {sides}"] = time_ms(lambda: threestep_vmem.threestep_pass_b(*a),
                                               graph=True)
        del xr, xi, a
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_pass1_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    trees = sys.argv[1:]
    runs = {tree: [] for tree in trees}
    for tree in trees + trees[::-1]:  # in turns
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"torch_pass1_sweep: the worker of {tree} exited {out.returncode}")
        runs[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
    first = trees[0]
    for case in runs[first][0]:
        means = {tree: statistics.mean(r[case] for r in runs[tree]) for tree in trees}
        print(f"sweep {case}: " + ", ".join(
            f"{tree} {[round(r[case], 4) for r in runs[tree]]} mean {means[tree]:.4f} ms"
            + ("" if tree == first else f" ({means[tree] / means[first]:.3f})")
            for tree in trees) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
