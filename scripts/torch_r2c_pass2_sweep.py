"""Time pass 2's unpack mode (the fused r2c's last launch) on one CUDA card:
R = 8 and 16 rows a block at every half size m = 2^15..2^20 of the fused
r2c, and at 16 x 2^20 the unpack mode against the two launches it
replaces (pass 2, then `herm_unpack`) and the two-launch r2c against the
three-launch one, in turns.

Run from the root of a checkout:

    python3 scripts/torch_r2c_pass2_sweep.py [--rounds N]

Every case is first held against pass 2 plus `herm_unpack` on the same
intermediate (>= 110 dB), then timed as a CUDA graph of 10 calls
(chip_smoke.py's `time_ms(graph=True)`: the device time alone). The
cases of one shape run in turns, in order and then in reverse, `rounds`
times (3 by default). The script prints one `sweep` line a case: its
runs, their mean and the ratio to the shape's first case, beside the
card's name and power limit. Its readings chose the unpack mode's rows a
block (kernels/fourstep_vmem.py `pass2_unpack_geometry`; PERF.md §6).
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
POINTS = 1 << 24  # complex points of the half-size spectrum a call
MAIN_ROWS = 16  # the benchmark's 16 x 2^21 real samples: m = 2^20


def snr_db(got, want) -> float:
    gr, gi = (t.double() for t in got)
    wr, wi = (t.double() for t in want)
    err = float(((gr - wr) ** 2 + (gi - wi) ** 2).sum())
    return 10.0 * math.log10(float((wr ** 2 + wi ** 2).sum()) / max(err, 1e-300))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_r2c_pass2_sweep: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import time_ms
    from fftlab_torch.kernels import _build, fourstep_vmem as fv, rfft_vmem

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    counts = dict.fromkeys(fv.LAUNCHES, 0)

    def in_turns(label: str, cases: dict) -> None:
        """Hold each case against the first's output, then time them in
        turns and print a line each."""
        outs = {name: fn() for name, fn in cases.items()}
        first = next(iter(cases))
        for name, out in outs.items():
            s = snr_db(out, outs[first])
            if s < 110.0:
                raise SystemExit(f"torch_r2c_pass2_sweep: {label} {name} reads {s:.1f} dB "
                                 f"against {first}")
        runs = {name: [] for name in cases}
        order = list(cases)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                runs[name].append(time_ms(cases[name], graph=True))
        base = statistics.mean(runs[first])
        for name, r in runs.items():
            mean = statistics.mean(r)
            print(f"sweep {label} {name}: {[round(v, 4) for v in r]} mean {mean:.4f} ms "
                  f"({mean / base:.3f}) [{card}]", flush=True)

    for e in range(15, 21):
        m = 1 << e
        L1, L2 = fv._split_sides(m)
        x = torch.randn(max(1, POINTS // m), 2 * m, generator=gen, device=dev)
        mid = fv.fourstep_pass1_packed(x)
        cases = {"pass2+herm_unpack": lambda: rfft_vmem.herm_unpack(*fv.fourstep_pass2(*mid))}
        for R in (8, 16):
            geo = fv.pass2_unpack_geometry(L1, L2, R)
            cases[f"unpack R={R}"] = (
                lambda geo=geo: fv._launch_pass2_unpack(*mid, 1.0, counts, geo))
        in_turns(f"{x.shape[0]} x 2^{e} (L1={L1}, L2={L2}, default "
                 f"R={fv.pass2_unpack_geometry(L1, L2).T})", cases)
        del x, mid, cases
        torch.cuda.empty_cache()

    m = 1 << 20
    x = torch.randn(MAIN_ROWS, 2 * m, generator=gen, device=dev)
    in_turns(f"r2c {MAIN_ROWS} x 2^21", {
        "three launches": lambda: rfft_vmem.herm_unpack(
            *fv.fourstep_pass2(*fv.fourstep_pass1_packed(x))),
        "two launches": lambda: fv.fourstep_pass2_unpack(*fv.fourstep_pass1_packed(x)),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
