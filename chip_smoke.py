#!/usr/bin/env python3
"""Drive fftlab_torch's main path once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the exit code is non-zero:

1. device: require a CUDA card; print nvidia-smi's name and power limit;
2. build: compile the kernels from fftlab_torch/csrc with nvcc;
3. kernels: each kernel's wrapper on card tensors at the main path's
   shapes, forward, inverse and scale=0.5, against its plain version
   (SNR >= 110 dB) and a float64 oracle (torch.fft on complex128, used as
   an oracle only: >= 120 dB two-pass, >= 110 dB rows);
4. main path: plan_dft_1d_split(2^20, batch=16) forward and inverse,
   fft_split_auto at 256 x 16384, with the kernels' launch counts;
5. timing: CUDA events, median of 25 runs after warm-up, of each kernel,
   its plain version and torch.fft.fft on complex64 (cuFFT, comparator);
6. result: one JSON line of kernels, then the device line last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROWS_SHAPES = ((256, 8192), (128, 16384))
TWO_PASS_SHAPES = ((64, 1 << 15), (16, 1 << 20), (4, 1 << 21))
MAIN_SHAPE = (16, 1 << 20)
ROWS_MAIN_SHAPE = (256, 16384)
GATE_PLAIN_DB = 110.0
GATE_ORACLE_DB = {"rows": 110.0, "two_pass": 120.0}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # phase 1: the device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fftlab_torch import INVERSE, fft_split_auto, plan_dft_1d_split
    from fftlab_torch.core.types import FORWARD
    from fftlab_torch.kernels import _build, fft_vmem, fourstep_vmem
    from fftlab_torch.plan.dispatch import select_split_impl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def planes(B, n):
        return (torch.randn(B, n, generator=gen, device=dev),
                torch.randn(B, n, generator=gen, device=dev))

    # phase 2: build
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib._name})")

    # phase 3: every kernel against its plain version and the oracle
    def snr_db(got, want) -> float:
        gr, gi = (g.double() for g in got)
        wr, wi = (w.double() for w in want)
        num = (wr * wr + wi * wi).sum()
        den = ((gr - wr) ** 2 + (gi - wi) ** 2).sum().clamp_min(1e-300)
        return float(10 * torch.log10(num / den))

    def oracle(xr, xi, direction, scale):
        z = torch.complex(xr.double(), xi.double())
        n = z.shape[-1]
        y = torch.fft.fft(z) if direction == FORWARD else torch.fft.ifft(z) * n
        y = y * scale
        return y.real, y.imag

    def max_abs(a, b) -> float:
        return max(float((a[0] - b[0]).abs().max()),
                   float((a[1] - b[1]).abs().max()))

    cases = ((FORWARD, None), (INVERSE, None), (FORWARD, 0.5))
    err = {"fft_rows": 0.0, "fourstep_pass1": 0.0, "fourstep_pass2": 0.0}
    for B, n in ROWS_SHAPES:
        xr, xi = planes(B, n)
        for d, user in cases:
            eff = (1.0 / n if d == INVERSE else 1.0) * (user or 1.0)
            got = fft_vmem.fft_rows(xr, xi, d, eff)
            plain = fft_vmem.fft_rows_plain(xr, xi, d, eff)
            torch.cuda.synchronize()
            s_plain = snr_db(got, plain)
            s_oracle = snr_db(got, oracle(xr, xi, d, eff))
            err["fft_rows"] = max(err["fft_rows"], max_abs(got, plain))
            print(f"check fft_rows B={B} n={n} dir={int(d)} scale={eff:.6g}: "
                  f"vs plain {s_plain:.1f} dB, vs oracle {s_oracle:.1f} dB")
            require(s_plain >= GATE_PLAIN_DB, f"fft_rows vs plain {s_plain:.1f} dB")
            require(s_oracle >= GATE_ORACLE_DB["rows"],
                    f"fft_rows vs oracle {s_oracle:.1f} dB")
    for B, n in TWO_PASS_SHAPES:
        xr, xi = planes(B, n)
        for d, user in cases:
            eff = (1.0 / n if d == INVERSE else 1.0) * (user or 1.0)
            mid = fourstep_vmem.fourstep_pass1(xr, xi, d)
            mid_plain = fourstep_vmem.fourstep_pass1_plain(xr, xi, d)
            got = fourstep_vmem.fourstep_pass2(*mid, d, eff)
            plain2 = fourstep_vmem.fourstep_pass2_plain(*mid, d, eff)
            plain = fourstep_vmem.fourstep_pass2_plain(*mid_plain, d, eff)
            torch.cuda.synchronize()
            s1 = snr_db(mid, mid_plain)
            s2 = snr_db(got, plain2)
            s_plain = snr_db(got, plain)
            s_oracle = snr_db(got, oracle(xr, xi, d, eff))
            err["fourstep_pass1"] = max(err["fourstep_pass1"], max_abs(mid, mid_plain))
            err["fourstep_pass2"] = max(err["fourstep_pass2"], max_abs(got, plain2))
            print(f"check two_pass B={B} n={n} dir={int(d)} scale={eff:.6g}: "
                  f"pass1 vs plain {s1:.1f} dB, pass2 vs plain {s2:.1f} dB, "
                  f"whole vs plain {s_plain:.1f} dB, vs oracle {s_oracle:.1f} dB")
            for name, s in (("fourstep_pass1", s1), ("fourstep_pass2", s2),
                            ("two_pass", s_plain)):
                require(s >= GATE_PLAIN_DB, f"{name} vs plain {s:.1f} dB at B={B} n={n}")
            require(s_oracle >= GATE_ORACLE_DB["two_pass"],
                    f"two_pass vs oracle {s_oracle:.1f} dB at B={B} n={n}")

    # phase 4: the main path, through the public entry points
    for counts in (fft_vmem.LAUNCHES, fourstep_vmem.LAUNCHES):
        for k in counts:
            counts[k] = 0
    B, n = MAIN_SHAPE
    xr, xi = planes(B, n)
    fwd = plan_dft_1d_split(n, batch=B)
    inv = plan_dft_1d_split(n, INVERSE, batch=B)
    yr, yi = fwd.execute((xr, xi))
    br, bi = inv.execute((yr, yi))
    B2, n2 = ROWS_MAIN_SHAPE
    ur, ui = planes(B2, n2)
    vr, vi = fft_split_auto(ur, ui)
    torch.cuda.synchronize()
    launches = {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES}
    print(f"main path launches: {launches}")
    require(fwd.algorithm == "two_pass" and inv.algorithm == "two_pass",
            f"2^20 routes {fwd.algorithm}, {inv.algorithm}")
    require(select_split_impl(n2, B2) == "smem_rows",
            f"16384 route {select_split_impl(n2, B2)}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    for t, shape in ((yr, (B, n)), (yi, (B, n)), (br, (B, n)), (bi, (B, n)),
                     (vr, (B2, n2)), (vi, (B2, n2))):
        require(tuple(t.shape) == shape and t.dtype == torch.float32,
                f"output {tuple(t.shape)} {t.dtype}, want {shape} float32")
        require(bool(torch.isfinite(t).all()), "non-finite output")
    s_fwd = snr_db((yr, yi), oracle(xr, xi, FORWARD, 1.0))
    s_rt = snr_db((br, bi), (xr, xi))
    s_rows = snr_db((vr, vi), oracle(ur, ui, FORWARD, 1.0))
    print(f"main path: 16 x 2^20 forward vs oracle {s_fwd:.1f} dB, round trip "
          f"{s_rt:.1f} dB; 256 x 16384 fft_split_auto vs oracle {s_rows:.1f} dB")
    require(s_fwd >= 120.0, f"main path forward {s_fwd:.1f} dB")
    require(s_rt >= 120.0, f"main path round trip {s_rt:.1f} dB")
    require(s_rows >= GATE_ORACLE_DB["rows"], f"rows main path {s_rows:.1f} dB")

    # phase 5: timing with CUDA events
    def time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        runs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        return statistics.median(runs)

    ms = {}
    B, n = MAIN_SHAPE
    xr, xi = planes(B, n)
    mid = fourstep_vmem.fourstep_pass1(xr, xi, FORWARD)
    xc = torch.complex(xr, xi)
    ms["two_pass"] = time_ms(lambda: fourstep_vmem.fft_split_large(xr, xi))
    ms["two_pass_plain"] = time_ms(lambda: fourstep_vmem.fourstep_pass2_plain(
        *fourstep_vmem.fourstep_pass1_plain(xr, xi)))
    ms["fourstep_pass1"] = time_ms(lambda: fourstep_vmem.fourstep_pass1(xr, xi))
    ms["fourstep_pass1_plain"] = time_ms(
        lambda: fourstep_vmem.fourstep_pass1_plain(xr, xi))
    ms["fourstep_pass2"] = time_ms(lambda: fourstep_vmem.fourstep_pass2(*mid))
    ms["fourstep_pass2_plain"] = time_ms(
        lambda: fourstep_vmem.fourstep_pass2_plain(*mid))
    ms["cufft_1m"] = time_ms(lambda: torch.fft.fft(xc))
    B2, n2 = ROWS_MAIN_SHAPE
    ur, ui = planes(B2, n2)
    uc = torch.complex(ur, ui)
    ms["fft_rows"] = time_ms(lambda: fft_vmem.fft_rows(ur, ui))
    ms["fft_rows_plain"] = time_ms(lambda: fft_vmem.fft_rows_plain(ur, ui))
    ms["cufft_16k"] = time_ms(lambda: torch.fft.fft(uc))
    for name, t in ms.items():
        shape = ROWS_MAIN_SHAPE if name in ("fft_rows", "fft_rows_plain",
                                           "cufft_16k") else MAIN_SHAPE
        gsps = shape[0] * shape[1] / (t * 1e6)
        print(f"time {name} {shape[0]}x{shape[1]}: {t:.4f} ms "
              f"({gsps:.2f} GS/s) [{card}]")

    # phase 6: the result
    src = "fftlab_torch/csrc/"
    kernels = [
        {"name": "fft_rows", "route": "cuda", "source": src + "fft_rows.cu",
         "replaces": "fftlab/kernels/fft_vmem.py:176",
         "launches": launches["fft_rows"], "max_abs_err": err["fft_rows"],
         "ms": ms["fft_rows"], "plain_ms": ms["fft_rows_plain"]},
        {"name": "fourstep_pass1", "route": "cuda", "source": src + "fourstep.cu",
         "replaces": "fftlab/kernels/fourstep_vmem.py:584",
         "also_replaces": "fftlab/kernels/resident_vmem.py:433",
         "launches": launches["fourstep_pass1"], "max_abs_err": err["fourstep_pass1"],
         "ms": ms["fourstep_pass1"], "plain_ms": ms["fourstep_pass1_plain"]},
        {"name": "fourstep_pass2", "route": "cuda", "source": src + "fourstep.cu",
         "replaces": "fftlab/kernels/fourstep_vmem.py:628",
         "also_replaces": "fftlab/kernels/resident_vmem.py:433",
         "launches": launches["fourstep_pass2"], "max_abs_err": err["fourstep_pass2"],
         "ms": ms["fourstep_pass2"], "plain_ms": ms["fourstep_pass2_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
