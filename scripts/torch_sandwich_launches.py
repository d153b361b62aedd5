"""Time the three launches of fftlab_torch's two-pass sandwich on a CUDA card.

At each two-pass size it measures (chip_smoke.py's `time_ms`: 10 calls
between CUDA events, median of 25), beside the card's name and power
limit:
- `spectral_filter_large` as called and as a CUDA graph of the 10 calls
  (the device time alone);
- each launch alone: pass 1, pass 2's sandwich mode (in place, with an
  all-pass H times L1 so that each call keeps its input's scale) at every
  R of 2, 4, 8 and 16 whose tile fits, in turns (a b c ... c b a), each R
  first checked against the plain version (>= 110 dB), and the inverse
  pass 1 in its mode with no twiddle;
- the inverse pass 1 through the plain pass-1 kernel with twiddle tables
  of ones, the form the no-twiddle mode replaces;
after two seconds of sandwiches at 16 x 2^20, which bring the card to its
clocks.

Needs a card:

    python3 scripts/torch_sandwich_launches.py
"""

from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GATE_PLAIN_DB, time_ms  # noqa: E402
from fftlab_torch.core.types import INVERSE, log2_int  # noqa: E402
from fftlab_torch.kernels import _build, fourstep_vmem  # noqa: E402
from fftlab_torch.kernels._common import complex_table  # noqa: E402

SHAPES = ((64, 1 << 15), (64, 1 << 17), (32, 1 << 19), (16, 1 << 20), (4, 1 << 21))


def snr_db(got, want) -> float:
    num = sum(float(w.double().square().sum()) for w in want)
    den = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    return 10 * math.log10(num / max(den, 1e-300))


def pass1_with_ones(xr, xi, sides):
    """The inverse pass 1 as the plain pass-1 kernel with A, P and S of
    ones (it reads A and P, or S from L1 = STAGED_MIN_L1)."""
    L1, L2 = sides
    geo = fourstep_vmem.pass1_geometry(L1, L2)
    tw1 = fourstep_vmem._pass1_tables(L1, L2, INVERSE, xr.device)[0]
    a_tab = complex_table(np.ones((L2 // fourstep_vmem.PASS1_WIDTH, L1)), xr.device)
    p_tab = complex_table(np.ones((L1, fourstep_vmem.PASS1_WIDTH)), xr.device)
    s_tab = complex_table(np.ones((fourstep_vmem.staged_rows(L1), L2)), xr.device)
    mr, mi = torch.empty_like(xr), torch.empty_like(xi)
    args = (xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(), tw1.data_ptr(),
            a_tab.data_ptr(), p_tab.data_ptr(), s_tab.data_ptr(), xr.shape[0], log2_int(L1),
            log2_int(L2), log2_int(geo.T), geo.c_struct(), int(INVERSE))
    counts = {"fourstep_pass1": 0}
    return lambda: _build.launch("fftlab_fourstep_pass1", "fourstep_pass1", counts, xr, args)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = dict.fromkeys(fourstep_vmem.LAUNCHES, 0)
    # two seconds of sandwiches before the first reading: without them the
    # first shape's launches read about twice their time in other runs
    wr, wi, hw = (torch.randn(16, 1 << 20, generator=gen, device=dev) for _ in range(3))
    start = time.perf_counter()
    while time.perf_counter() - start < 2.0:
        fourstep_vmem.spectral_filter_large(wr, wi, hw[0], hw[1])
        torch.cuda.synchronize()
    del wr, wi, hw
    for B, n in SHAPES:
        sides = fourstep_vmem._split_sides(n)
        L1, L2 = sides
        xr, xi = (torch.randn(B, n, generator=gen, device=dev) for _ in range(2))
        hr, hi = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
        phase = 2 * math.pi * torch.rand(n, generator=gen, device=dev)
        ar, ai = L1 * torch.cos(phase), L1 * torch.sin(phase)
        mid = fourstep_vmem.fourstep_pass1(xr, xi)
        want = fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, hr, hi)
        geos = {R: fourstep_vmem.sandwich_geometry(L1, L2, R)
                for R in (2, 4, 8, 16) if R * L2 <= 16384}
        for R, geo in geos.items():
            got = fourstep_vmem._launch_sandwich(*(t.clone() for t in mid), hr, hi, counts,
                                                 geometry=geo)
            s = snr_db(got, want)
            if s < GATE_PLAIN_DB:
                raise SystemExit(f"sandwich mode R={R} at 2^{log2_int(n)}: {s:.1f} dB vs plain")
        runs = {R: [] for R in geos}
        for R in list(geos) + list(geos)[::-1]:  # in turns
            runs[R].append(time_ms(lambda: fourstep_vmem._launch_sandwich(
                *mid, ar, ai, counts, geometry=geos[R])))
        if not all(bool(torch.isfinite(t).all()) for t in mid):
            raise SystemExit("the sandwich mode's timing input left its range")
        whole = lambda: fourstep_vmem.spectral_filter_large(xr, xi, hr, hi)
        t = {"calls": time_ms(whole), "graph": time_ms(whole, graph=True),
             "pass 1": time_ms(lambda: fourstep_vmem.fourstep_pass1(xr, xi)),
             "inverse pass 1, no twiddle": time_ms(lambda: fourstep_vmem._launch_pass1_no_twiddle(
                 "fourstep_pass1", *mid, INVERSE, sides, counts)),
             "inverse pass 1, tables of ones": time_ms(pass1_with_ones(*mid, sides))}
        default = fourstep_vmem.sandwich_geometry(L1, L2).T
        print(f"sandwich launches {B} x 2^{log2_int(n)}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + "; sandwich mode " + ", ".join(
                  f"R={R} {statistics.mean(v):.4f} ms {[round(x, 4) for x in v]}"
                  for R, v in runs.items())
              + f"; default R={default} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
