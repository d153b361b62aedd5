#!/usr/bin/env python3
"""Time fftlab_torch's kernels in two source trees on one CUDA card, in turns.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit, with a second tree unpacked beside it (for example the parent
commit: `mkdir -p _parent && git archive <commit> | tar -x -C _parent`):

    python3 chip_ab.py _parent .

Each tree runs in its own process, which puts the tree first on the
import path, builds its kernels from its own sources and times the same
cases on the same inputs; the processes run in turns (a b b a), and the
script prints each case's times per tree, their means and the ratio.
The cases: the filter kernels, `filter_rows` at 256 x 16384 and 64 x 1024
(the Bluestein and `fft_convolution_split` end) and `os_filter` on 2^23
samples x two planes with 129 taps in 1K and 16K frames and with 1025
taps in 2K frames; the two-pass sandwich `spectral_filter_large` at
64 x 2^15, 16 x 2^20 and 4 x 2^21, and Bluestein (`fft_split_auto`) at
4 x 500009, whose sandwich is 2^20, beside `torch.fft.fft`; `stft_frames` at 2^22 samples and frame/hop 256/128,
2048/512, 4096/1024 and 16384/4096 (one-sided), beside `torch.stft`;
`fft_rows` at 256 x 16384 beside `torch.fft.fft`; and the other
register-engine kernels (csrc/fft_reg.cuh): the two-pass pair at
16 x 2^20, its packed-real and interleaved modes at 8 x 2^21 and the
three passes of the huge-n FFT at 1 x 2^24; and the stage pipeline at
16 x 2^20 (`fft_split_pipeline`, factors (128, 64, 128)) with its two
stages as `fused_stage` calls. Each is timed both ways of
chip_smoke.py's `time_ms`: 10 back-to-back calls between CUDA events,
and a CUDA graph of the 10 calls (the device time alone).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

STFT_N = 1 << 22
STFT_CASES = ((256, 128), (2048, 512), (4096, 1024), (16384, 4096))
ROWS_SHAPE = (256, 16384)
PAIR_SHAPE = (16, 1 << 20)
REAL_SHAPE = (8, 1 << 21)
HUGE_SHAPE = (1, 1 << 24)
PIPELINE_SHAPE = (16, 1 << 20)
FILTER_ROWS_SHAPES = ((256, 16384), (64, 1024))
OS_N = 1 << 23
OS_CASES = ((129, 1024), (129, 16384), (1025, 2048))  # (taps, frame)
SANDWICH_SHAPES = ((64, 1 << 15), (16, 1 << 20), (4, 1 << 21))
BLUESTEIN_SHAPE = (4, 500009)
HERE = os.path.dirname(os.path.abspath(__file__))


def worker(tree: str) -> dict:
    """The cases' times in `tree`: {case: {"calls": ms, "graph": ms}}."""
    import torch

    from chip_smoke import time_ms  # this checkout's, before `tree` goes on the path

    sys.path.insert(0, os.path.abspath(tree))
    from fftlab_torch import INVERSE, fft_split_auto
    import numpy as np

    from fftlab_torch.kernels import (_build, fft_vmem, fourstep_vmem, os_filter_vmem,
                                      stage_fused, stft_vmem, threestep_vmem)

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def planes(B, n):
        return (torch.randn(B, n, generator=gen, device=dev),
                torch.randn(B, n, generator=gen, device=dev))

    cases = {}
    for B, n in FILTER_ROWS_SHAPES:
        fr, fi = planes(B, n)
        hr, hi = (h[0] for h in planes(1, n))
        cases[f"filter_rows {B} x {n}"] = (
            lambda fr=fr, fi=fi, hr=hr, hi=hi: fft_vmem.filter_rows(fr, fi, hr, hi))
    sr, si = planes(1, OS_N)
    rng = np.random.default_rng(0)
    for nh, fsz in OS_CASES:
        taps = rng.standard_normal(nh) / nh
        kr, ki = os_filter_vmem._cached_response(taps.tobytes(), fsz, dev)
        cases[f"os_filter 2^23 x 2, {nh} taps, {fsz} frames"] = (
            lambda kr=kr, ki=ki, nh=nh: os_filter_vmem.os_filter(sr, si, kr, ki, nh))
    for B, n in SANDWICH_SHAPES:
        zr, zi = planes(B, n)
        gr, gi = (h[0] for h in planes(1, n))
        cases[f"spectral_filter_large {B} x 2^{n.bit_length() - 1}"] = (
            lambda zr=zr, zi=zi, gr=gr, gi=gi: fourstep_vmem.spectral_filter_large(zr, zi, gr, gi))
    br, bi = planes(*BLUESTEIN_SHAPE)
    bc = torch.complex(br, bi)
    cases["Bluestein fft_split_auto 4 x 500009"] = lambda: fft_split_auto(br, bi)
    cases["torch.fft.fft 4 x 500009"] = lambda: torch.fft.fft(bc)
    sig = torch.randn(STFT_N, generator=gen, device=dev)
    for fft_size, hop in STFT_CASES:
        n_frames = (STFT_N - fft_size) // hop + 1
        w = stft_vmem.window_table("hann", fft_size, dev)
        cases[f"stft_frames {fft_size}/{hop}"] = (
            lambda w=w, f=fft_size, h=hop, k=n_frames: stft_vmem.stft_frames(sig, f, h, w, k))
        cases[f"torch.stft {fft_size}/{hop}"] = (
            lambda w=w, f=fft_size, h=hop: torch.stft(sig, f, h, window=w, center=False,
                                                      return_complex=True))
    ur, ui = planes(*ROWS_SHAPE)
    uc = torch.complex(ur, ui)
    cases["fft_rows 256 x 16384"] = lambda: fft_vmem.fft_rows(ur, ui)
    cases["torch.fft.fft 256 x 16384"] = lambda: torch.fft.fft(uc)
    xr, xi = planes(*PAIR_SHAPE)
    mid = fourstep_vmem.fourstep_pass1(xr, xi)
    cases["fourstep_pass1 16 x 2^20"] = lambda: fourstep_vmem.fourstep_pass1(xr, xi)
    cases["fourstep_pass2 16 x 2^20"] = lambda: fourstep_vmem.fourstep_pass2(*mid)
    x = torch.randn(*REAL_SHAPE, generator=gen, device=dev)
    pmid = fourstep_vmem.fourstep_pass1(*planes(REAL_SHAPE[0], REAL_SHAPE[1] // 2), INVERSE)
    n_real = REAL_SHAPE[1]
    cases["fourstep_pass1_packed 8 x 2^21"] = lambda: fourstep_vmem.fourstep_pass1_packed(x)
    cases["fourstep_pass2_interleaved 8 x 2^21"] = (
        lambda: fourstep_vmem.fourstep_pass2_interleaved(*pmid, INVERSE, 2.0 / n_real))
    hr, hi = planes(*HUGE_SHAPE)
    a = threestep_vmem.threestep_pass_a(hr, hi)
    b = threestep_vmem.threestep_pass_b(*a)
    cases["threestep_pass_a 1 x 2^24"] = lambda: threestep_vmem.threestep_pass_a(hr, hi)
    cases["threestep_pass_b 1 x 2^24"] = lambda: threestep_vmem.threestep_pass_b(*a)
    cases["threestep_pass_c 1 x 2^24"] = lambda: threestep_vmem.threestep_pass_c(*b)
    B, n = PIPELINE_SHAPE
    factors = stage_fused.pipeline_factors(n)
    r1, r2 = factors[0], factors[1]
    pr, pi = planes(B, n)
    s1r, s1i = (t.reshape(B * r1, n // r1) for t in stage_fused.fused_stage(pr, pi, r1))
    cases["stage_pipeline 16 x 2^20"] = (
        lambda: stage_fused.fft_split_pipeline(pr, pi, -1, factors))
    cases[f"fused_stage r={r1} 16 x 2^20"] = lambda: stage_fused.fused_stage(pr, pi, r1)
    cases[f"fused_stage r={r2} 16 x 2^20"] = lambda: stage_fused.fused_stage(s1r, s1i, r2)
    return {name: {"calls": time_ms(fn), "graph": time_ms(fn, graph=True)}
            for name, fn in cases.items()}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    trees = sys.argv[1:]
    runs = {tree: [] for tree in trees}
    for tree in trees + trees[::-1]:  # in turns: a b b a
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             cwd=HERE, capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"chip_ab: the worker of {tree} exited {out.returncode}")
        runs[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
    a, b = trees
    for case in runs[a][0]:
        for how in ("calls", "graph"):
            per = {tree: [r[case][how] for r in runs[tree]] for tree in trees}
            means = {tree: statistics.mean(v) for tree, v in per.items()}
            print(f"ab {case} [{how}]: {a} {per[a]} mean {means[a]:.4f} ms, {b} {per[b]} "
                  f"mean {means[b]:.4f} ms, {b}/{a} {means[b] / means[a]:.3f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
