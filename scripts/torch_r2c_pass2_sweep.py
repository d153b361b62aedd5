"""Time pass 2's unpack mode (the fused r2c's last launch) in two or more
source trees on one CUDA card, in turns: R = 8 and 16 rows a block at every
half size m = 2^15..2^20 of the fused r2c, beside the two launches it
replaces (pass 2, then `herm_unpack`), and at 16 x 2^21 reals the
two-launch r2c against the three-launch one.

Run from the root of a checkout, with the other tree unpacked beside it
(for example the parent commit: `mkdir -p _parent && git archive <commit>
| tar -x -C _parent`):

    python3 scripts/torch_r2c_pass2_sweep.py _parent . [--rounds N]
        [--sizes 15,...,20] [--control TREE ...]

Each tree runs in its own process, which puts the tree first on the import
path and builds its kernels from its own sources; the processes run in
turns (t1 t2 ... t2 t1), `rounds` times (2 by default), at the half sizes
2^e that `--sizes` lists (the r2c cases with e = 20). Every case moves
2^24 points of half-size spectrum (batch 2^24/m) and is timed as a CUDA
graph of 10 calls (chip_smoke.py's `time_ms(graph=True)`: the device time
alone). Each case is first held against pass 2 plus `herm_unpack` of its
own tree on the same intermediate (>= 110 dB); a tree named by
`--control` (a copy with a part of the kernel taken out on purpose, to
time what that part costs) is timed and its reading printed, not held.
The script prints one `sweep` line a case: each tree's runs, their mean
and the ratio to the first tree's, beside the card's name and power
limit. Its readings chose the unpack mode's rows a block
(kernels/fourstep_vmem.py `pass2_unpack_geometry`) and measured its
exchange (PERF.md §6).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 1 << 24  # complex points of the half-size spectrum a call
MAIN_ROWS = 16  # the benchmark's 16 x 2^21 real samples: m = 2^20


def snr_db(got, want) -> float:
    gr, gi = (t.double() for t in got)
    wr, wi = (t.double() for t in want)
    err = float(((gr - wr) ** 2 + (gi - wi) ** 2).sum())
    return 10.0 * math.log10(float((wr ** 2 + wi ** 2).sum()) / max(err, 1e-300))


def worker(tree: str, sizes: list[int]) -> dict:
    """{case: [ms a call, dB against pass 2 plus herm_unpack]} in `tree`,
    at the half sizes 2^e, e in `sizes`."""
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms  # this checkout's, before `tree` goes on the path

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from fftlab_torch.kernels import _build, fourstep_vmem as fv, rfft_vmem

    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    counts = dict.fromkeys(fv.LAUNCHES, 0)
    out = {}

    def case(name: str, fn, want) -> None:
        out[name] = [time_ms(fn, graph=True), snr_db(fn(), want)]

    for e in sizes:
        m = 1 << e
        L1, L2 = fv._split_sides(m)
        x = torch.randn(max(1, POINTS // m), 2 * m, generator=gen, device=dev)
        mid = fv.fourstep_pass1_packed(x)
        label = f"{x.shape[0]} x 2^{e} (L1={L1}, L2={L2})"
        want = rfft_vmem.herm_unpack(*fv.fourstep_pass2(*mid))
        case(f"{label} pass2+herm_unpack", lambda: rfft_vmem.herm_unpack(*fv.fourstep_pass2(*mid)),
             want)
        for R in (8, 16):
            geo = fv.pass2_unpack_geometry(L1, L2, R)
            default = " (default)" if geo.T == fv.pass2_unpack_geometry(L1, L2).T else ""
            case(f"{label} unpack R={R}{default}",
                 lambda geo=geo: fv._launch_pass2_unpack(*mid, 1.0, counts, geo), want)
        del x, mid, want
        torch.cuda.empty_cache()

    if 20 not in sizes:
        return out
    x = torch.randn(MAIN_ROWS, 2 << 20, generator=gen, device=dev)
    want = rfft_vmem.herm_unpack(*fv.fourstep_pass2(*fv.fourstep_pass1_packed(x)))
    case(f"r2c {MAIN_ROWS} x 2^21 three launches",
         lambda: rfft_vmem.herm_unpack(*fv.fourstep_pass2(*fv.fourstep_pass1_packed(x))), want)
    case(f"r2c {MAIN_ROWS} x 2^21 two launches",
         lambda: fv.fourstep_pass2_unpack(*fv.fourstep_pass1_packed(x)), want)
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2], [int(e) for e in sys.argv[3].split(",")])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sizes", default="15,16,17,18,19,20")
    ap.add_argument("--control", action="append", default=[])
    args = ap.parse_args()
    if not set(map(int, args.sizes.split(","))) <= set(range(15, 21)):
        raise SystemExit(f"torch_r2c_pass2_sweep: --sizes takes exponents in 15..20; got "
                         f"{args.sizes}")
    import torch

    if not torch.cuda.is_available():
        print("torch_r2c_pass2_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    trees = args.trees + [t for t in args.control if t not in args.trees]
    runs = {tree: [] for tree in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:  # in turns
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                                  args.sizes],
                                 cwd=ROOT, capture_output=True, text=True, timeout=900)
            if out.returncode:
                sys.stderr.write(out.stdout + out.stderr)
                raise SystemExit(f"torch_r2c_pass2_sweep: the worker of {tree} exited "
                                 f"{out.returncode}")
            runs[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
    first = trees[0]
    failed = []
    for name in runs[first][0]:
        cells = []
        for tree in trees:
            ms = [r[name][0] for r in runs[tree]]
            db = min(r[name][1] for r in runs[tree])
            mean = statistics.mean(ms)
            base = statistics.mean(r[name][0] for r in runs[first])
            cells.append(f"{tree} {[round(v, 4) for v in ms]} mean {mean:.4f} ms"
                         + ("" if tree == first else f" ({mean / base:.3f})")
                         + f" {db:.1f} dB")
            if db < 110.0 and tree not in args.control:
                failed.append(f"{tree} {name} {db:.1f} dB")
        print(f"sweep {name}: " + ", ".join(cells) + f" [{card}]", flush=True)
    if failed:
        raise SystemExit("torch_r2c_pass2_sweep: under 110 dB against pass 2 plus herm_unpack: "
                         + "; ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
