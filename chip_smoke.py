#!/usr/bin/env python3
"""Drive fftlab_torch's main path once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the exit code is non-zero:

1. device: require a CUDA card; print nvidia-smi's name and power limit;
2. build: compile the kernels from fftlab_torch/csrc with nvcc, print
   ptxas's registers and spills of every kernel, and fail on a spill;
3. kernels: each kernel's wrapper on card tensors at the main paths'
   shapes against its plain version (SNR >= 110 dB) and a float64 oracle
   (torch.fft on complex128 and np.convolve, used as oracles only):
   the c2c kernels forward, inverse and scale=0.5 (>= 120 dB two-pass,
   >= 110 dB rows); the sandwiches ifft(fft(x) * H) with a random H
   (>= 110 dB `filter_rows`, also at 64 x 1024; at 64 x 2^15, 16 x 2^20
   and 4 x 2^21 `fourstep_pass2_sandwich`, pass 2's sandwich mode, >= 110
   dB against its plain version, and the three-launch sandwich >= 110 dB
   against its plain version and >= 120 dB against float64); `os_filter` at
   2 x 2^20 with 9, 129 and 1025 taps in 16K frames, 129 taps in 1K
   frames and 1025 taps in 2K frames against np.convolve (>= 100 dB);
   the real-signal kernels at 8 x 2^21 and 4 x 2^22 reals
   and 2^22 samples: `pack_real` and `interleave` bit-exact,
   `herm_unpack`, `herm_repack`, the packed pass 1 and the interleaved
   pass 2 (8 x 2^21) and
   `stft_frames` (2048/512, 256/128) >= 110 dB against their plain
   versions and np.fft-style float64 oracles; the three-pass kernels
   (`threestep_pass_a/b/c`) at 4 x 2^22, 1 x 2^24 and 1 x 2^26 (each
   pass vs plain, the whole vs float64 >= 120 dB) and `fused_stage` at
   the JAX suite's (r, M), every pow2 r in 2..128 and the pipelines'
   stage shapes, with and without the twiddle (>= 115 dB vs a float64
   einsum), and the pipelines' swap stages (`swap_stage`) and leaves
   (`stage_leaf`) at their main-path shapes against their plain versions;
4. main paths, each with every launch count set to 0 just before it and
   read just after: (a) the FFT, plan_dft_1d_split(2^20, batch=16)
   forward and inverse and fft_split_auto at 256 x 16384; (b) the filter
   path, spectral_filter_auto at 16 x 2^20 (exactly two `fourstep_pass1`
   launches and one `fourstep_pass2_sandwich`, printed), fft_filter_split at
   256 x 16384, fft_split_auto at 4 x 500009 (Bluestein, m = 2^20: a
   sandwich forward and one inverse, their launches printed) and
   64 x 509 (Bluestein, m = 1024, the row sandwich) and FilterPlan on a
   2^23-sample signal (two planes, packed real, stream);
   (c) the real-signal path, plan_r2c_1d_split(2^21, batch=8) (the fused
   kernels) and plan_c2r_1d_split on its output, the r2c/c2r plans at
   4 x 2^22 (pack -> two_pass at 2^21 -> unpack, and back), stft_split of
   2^22 samples at 2048/512 and 256/128, istft_split of the first, and
   welch_psd_split and coherence_split on 2^22 samples; (d) the huge-n
   path, each call with its own reset and read: plan_dft_1d_split(2^24)
   forward and inverse (bench.py's fft_16m_single), fft_split_auto at
   4 x 2^22 and 1 x 2^26, the r2c/c2r plans at 4 x 2^23 (half size on
   three passes), plan_from_jax("pallas_pipeline", 2^20) at 16 x 2^20
   and run_route("stage_pipeline") at 2 x 2^15 (each K - 1 stage launches
   and one leaf launch); (e) the complex API (`complex_api_phase`):
   fft/ifft at 16 x 2^20 complex64 on ESTIMATE's stockham_mxu (>= 120 dB)
   timed beside torch.fft.fft and the split route, fft(algorithm=
   "pallas_vmem") at 256 x 16384 with exactly one `fft_rows` launch a call
   (>= 120 dB vs float64 and vs the plain version), every registry
   algorithm at 64 rows (>= 110 dB), rfft/irfft at 8 x 2^21 and
   fft2/ifft2 at 2048 x 2048 (>= 110 dB), MEASURE of plan_dft_1d(2^16)
   and of plan_dft_1d_split(2^20, batch=16) (a kernel route must win,
   >= 120 dB) and of the split routes at 256 x 8192 and 4 x 2^21, each
   candidate's ms printed, the wisdom in a temporary file; (f) the DSP
   (`dsp_phase`); (g) the single-card edges (`edges_phase`): the native
   library built with g++ into fftlab_torch/_build/native/, cli/serve at
   its defaults on a 2^23-sample 48 kHz WAV (257 taps, 64K chunks: one
   `os_filter` launch a chunk; the stream >= 100 dB vs float64 np.convolve
   on a 128K prefix, each tone's attenuation within 0.1 dB of the CPU run
   on a 2^20 prefix; Msamples/s, the time split by trace spans, the
   kernel's share), bigfft (`fft_split_large` at 1 x 2^20 in 2 launches,
   >= 120 dB; the 16K x 257 split convolution within 1e-4 of
   np.convolve), the lowprec modes at 16 x 2^20 (f32 >= 120 dB, f32 >=
   f32x3 >= bf16 > 20 dB, each timed; the q15 row), the harness at 1024
   and 16384 (every round trip ok) and a profiler trace under
   chiprun_out/; (h) the sharded paths (`dist_phase`), each call with
   its own reset and read: (a) in this process, a world of one rank on
   NCCL over a file store, `four_step_fft_sharded_split` at 1 x 2^24
   (chunks 1 and 4, flatten=False, the inverse; 2 and 5 `fft_rows`
   launches, >= 120 dB vs float64 and >= 110 dB vs `fft_split_auto`, the
   chunked and block forms bit-identical), `plan_dft_1d_sharded(2^24)`,
   `FilterPlan(h, mesh=)` on 2^23 samples x two planes with 129 taps (one
   `os_filter` launch, >= 100 dB vs np.convolve on a 128K prefix),
   `fft2_sharded_split` and `fft2_mesh2d_split` at 2048 x 2048,
   `tp_spectral_filter_split` at 2^24, `pp_spectral_pipeline_split` on 64
   blocks of 16384, `welch_psd_sharded` (256) and `stft_sharded`
   (2048/512) on 2^22 samples and the dp x sp filterbank on 4 x 2^20,
   each against float64 and the single-device entry point, the four-step
   and `FilterPlan(mesh=)` timed beside `fft_split_auto`, cuFFT and
   `FilterPlan`; (b) four gloo ranks spawned on the one card under a
   deadline, the same calls on the same inputs, every result against
   (a)'s and float64, the overlap-save seams (+-256 samples around every
   shard boundary) against np.convolve, each rank's launches and
   host-clock times (gloo through the host; not a scaling figure) and
   the bytes gloo moved through the host; then every shape that (a) and
   (b) gave `fft_rows` and `os_filter` (logged as each launch passes,
   `kernel_shapes`) on fresh planes against the plain versions (>= 110
   dB) and float64, into the kernels line's max_abs_err; (i) the
   public entries (`entries_phase`): (a) `fftlab_torch.kernels`'
   `pallas_fft_split` and `pallas_spectral_filter` at 256 x 16384,
   `fft_split_resident_cio` (inverse) at 16 x 2^20, `pallas_stft_split`
   on 2^22 samples at 2048/512 and `fft_split_pipeline` (64, 128, 128)
   at 16 x 2^20, one reset and read for the five calls (launches exact),
   each against its plain version and float64 (>= 120 dB, 115 the
   pipeline, 110 the STFT); (b) the JAX-order calls of F1 and F2 raise
   TypeError, their keyword forms and F3 (`precision` 6th) clear the
   gates; (c) the nine algorithm module demos as `python -m`
   subprocesses, each exiting 0 with PASS; (d) `copy_bandwidth()` in GB/s
   beside the published 3350, `quick_bandwidth()` beside the device
   time of its chain's kernels (profiler), a reading above 105% of
   3350 fails either, `chain_time` of `fft_split_auto` at 16 x 2^20
   beside `time_ms`; (e) `entry()` >= 120 dB, `dryrun_multichip` at
   world 1 on NCCL and in four gloo ranks sharing the card, and `python
   -m fftlab_torch.examples.minimal`.
   Every output of a main path is held against the plain versions on
   the same inputs (>= 110 dB, over every sample) and against an oracle;
5. timing: CUDA events around 10 back-to-back calls, median of 25 such
   runs after warm-up, of each kernel, its plain version and the library
   call that computes the same function, where one does (torch.fft on
   complex64, i.e. cuFFT; torch.fft.rfft / irfft, torch.stft(center=False),
   conv1d for the FIR, torch.stack for the interleave), the einsum route
   at 1 x 2^24, the A/B of the fused r2c (3 launches) against the
   pipeline (4 launches) at 8 x 2^21, in turns, and the geometry A/B of
   the two-pass kernels at 16 x 2^20 and 4 x 2^21 (W columns per pass-1
   block, R rows per pass-2 block and per block of the sandwich mode),
   each candidate checked against the
   plain version first and timed in turns; `stft_frames` and
   `fft_rows`, whose wrappers' host time per call can be as long as the
   kernel, and their library calls are also timed as CUDA graphs of the
   10 calls (the device time alone), and so is the A/B of `stft_frames`'
   frames per block (T in {16, 32} at 256/128, {2, 4} at 2048/512);
   the three-launch sandwich at 64 x 2^15, 16 x 2^20 and 4 x 2^21 beside
   cuFFT's three calls, and Bluestein at 4 x 500009 beside torch.fft.fft;
   `filter_rows` (256 x 16384, 64 x 1024) and `os_filter` at the serving
   shape (1K and 16K frames) are timed as calls and as graphs, beside the
   A/B of `os_filter`'s frames per block at 1K frames (T in {2, 4, 8}, graph,
   in turns) and its frame-size sweep (1K..16K frames at the serving
   shape, each checked against the plain version first; no default
   changes with it); and each DSP entry point of phase 4f beside the
   PyTorch call that computes the same function (torch.fft, torch.stft,
   torch.istft, conv1d), 5 calls between the events, median of 10, with
   its bound (bytes in and out over 3.35 TB/s);
6. result: one JSON line of kernels, each with its bound (the larger of
   its bytes in and out over 3.35 TB/s and its float32 operations over
   67 TFLOP/s, the H100 SXM's published peaks), then the device line
   last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROWS_SHAPES = ((256, 8192), (128, 16384), (256, 16384))
# filter_rows also at the Bluestein and fft_convolution_split end
FILTER_ROWS_SHAPES = ROWS_SHAPES + ((64, 1024),)
TWO_PASS_SHAPES = ((64, 1 << 15), (16, 1 << 20), (4, 1 << 21))
# the geometry A/B of the two-pass kernels: the headline shape and the
# window's top, whose L2 = 2048 rows take R <= 8
AB_SHAPES = ((16, 1 << 20), (4, 1 << 21))
MAIN_SHAPE = (16, 1 << 20)
ROWS_MAIN_SHAPE = (256, 16384)
FILTER_ROWS_MAIN_SHAPE = (256, 16384)
FILTER_MAIN_SHAPE = (16, 1 << 20)
OS_SHAPE = (2, 1 << 20)
# (taps, frame): bench.py's 16K frames, and FilterPlan's default frame for
# its 129 taps (fft_size = next_pow2(4 * 129) = 1024), which the serving
# main path runs
OS_CASES = ((9, 16384), (129, 16384), (1025, 16384), (129, 1024), (1025, 2048))
BLUESTEIN_SHAPE = (4, 500009)
# a prime whose sandwich is the row kernel's: m = next_pow2(2*509 - 1) = 1024
BLUESTEIN_ROWS_SHAPE = (64, 509)
# os_filter: the A/B of frames per block at 1K frames, and the frame sizes
# of the sweep at the serving shape
OS_AB_FRAMES = [2, 4, 8]
OS_SWEEP = (1024, 2048, 4096, 8192, 16384)
SERVING_N = 1 << 23
SERVING_TAPS = 129
# the np.convolve gate of the serving shape reads this prefix (bench.py
# bench_serving_filter); the stream runs over the first STREAM_CUTS[-1]
# samples in chunks of uneven sizes
PREFIX = 1 << 17
STREAM_CUTS = (0, 1000, 4096, 4097, 70001, 300000, 1 << 19, 777777, 1 << 20)
# the real-signal path: bench.py bench_rfft (8 x 2^21 reals, the fused
# kernels), the K7 pipeline at a half size of 2^21, and bench_stft's
# 2^22 samples at 2048/512 beside Welch's default segmenting (256/128)
RFFT_SHAPE = (8, 1 << 21)
RFFT_PIPE_SHAPE = (4, 1 << 22)
STFT_N = 1 << 22
STFT_CASES = ((2048, 512), (256, 128))
# the A/B of stft_frames' frames per block at each case's frame size
STFT_AB_FRAMES = {2048: [2, 4], 256: [16, 32]}
WELCH = 256 // 2 + 1  # bins of welch_psd_split's default 256-point segments
# the huge-n path: bench.py fft_16m_single (one 2^24 transform), the
# three-pass window's ends, the r2c at a half size of 2^22, and the JAX
# package's pallas_pipeline route at the headline shape
THREE_PASS_SHAPES = ((4, 1 << 22), (1, 1 << 24), (1, 1 << 26))
HUGE_MAIN_SHAPE = (1, 1 << 24)
HUGE_AUTO_SHAPES = ((4, 1 << 22), (1, 1 << 26))
HUGE_RFFT_SHAPE = (4, 1 << 23)
PIPELINE_SHAPE = (16, 1 << 20)
PIPELINE_SMALL_SHAPE = (2, 1 << 15)
# (batch, r, M): the JAX suite's stages (tests/test_stage_fused.py) and the
# stages of the two pipelines above
STAGE_SHAPES = ((4, 64, 2048), (4, 128, 1024), (4, 32, 128), (4, 2, 128),
                (4, 4, 256), (4, 8, 128), (4, 16, 512),
                (16, 128, 8192), (2048, 64, 128), (2, 128, 256), (256, 2, 128))
# (rows, r, M, F1) of the two pipelines' swap stages, and (batch, n, leaf)
# of their leaves
SWAP_SHAPES = ((2048, 64, 128, 128), (256, 2, 128, 128))
LEAF_SHAPES = ((16, 1 << 20, 128), (2, 1 << 15, 128))
GATE_PLAIN_DB = 110.0
# the launches of one two-pass sandwich: pass 1, the sandwich mode, the
# inverse pass 1
SANDWICH_LAUNCHES = {"fourstep_pass1": 2, "fourstep_pass2_sandwich": 1}
GATE_ORACLE_DB = {"rows": 110.0, "two_pass": 120.0, "os_filter": 100.0,
                  "bluestein": 95.0, "real": 110.0, "three_pass": 120.0,
                  "stage": 115.0}
# the published peaks of one H100 SXM (700 W): HBM3 and float32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12


def time_ms(fn, graph: bool = False, iters: int = 25, inner: int = 10,
            warmup: int = 10) -> float:
    """Median over `iters` runs of `inner` calls of `fn`, per call, timed
    between two CUDA events by the package's own protocol
    (fftlab_torch/bench/timing.py). The calls run back to back, so the
    host's enqueue of one call hides behind the previous one's kernels,
    unless the host takes longer per call than the card. With `graph`,
    the `inner` calls are captured once in a CUDA graph (after the
    warm-up, which builds the tables they use) and each run replays it:
    the device time alone. Both sides of a comparison are timed the same
    way."""
    import torch

    from fftlab_torch.bench import timing

    if not graph:
        return timing.time_ms(fn, "cuda", iters=iters, inner=inner, warmup=warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured):
        for _ in range(inner):
            fn()
    captured.replay()
    return timing.event_ms(captured.replay, iters, 1) / inner


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# the complex API: the registry's sizes at 64 rows (pow2 entries at 4096,
# the educational ones at their JAX test caps, tests/test_properties.py:41)
REGISTRY_ROWS = 64
REGISTRY_SIZES = {"mixed_radix": 3000, "four_step": 3000, "bluestein": 4099,
                  "recursive": 256, "iterative": 1024}
MEASURE_N = 1 << 16  # split_radix's eager recursion at 2^20 is tens of thousands of launches
SPLIT_TUNE_SMALL = (256, 8192)
# the window edge where two_pass and three_pass both take n (the static
# rule keeps two passes)
SPLIT_TUNE_EDGE = (4, 1 << 21)
FFT2_SHAPE = (2048, 2048)


def complex_api_phase(dev, gen, card: str, reset_counts, read_counts) -> None:
    """Phase 4e: the complex-dtype API on the card (see the module
    docstring). `reset_counts()` sets every kernel's launch count to 0
    and `read_counts()` reads them all. Every gate raises SmokeFailure."""
    import tempfile

    import torch

    from fftlab_torch import (fft, fft2, fft_split_auto, from_split, ifft, ifft2, irfft,
                              plan_dft_1d, plan_dft_1d_split, rfft, to_split)
    from fftlab_torch.algos import build_registry
    from fftlab_torch.kernels import fft_vmem
    from fftlab_torch.plan import split_tuning, wisdom
    from fftlab_torch.plan.flags import Flags

    t_phase = time.perf_counter()

    def cplx(B, n):
        return torch.complex(torch.randn(B, n, generator=gen, device=dev),
                             torch.randn(B, n, generator=gen, device=dev))

    def snr(got, want) -> float:
        got, want = got.to(torch.complex128), want.to(torch.complex128)
        err = (got - want).abs().square().sum().clamp_min(1e-300)
        return float(10 * torch.log10(want.abs().square().sum() / err))

    def f64(x):
        return x.to(torch.complex128)

    def gate(what, value, limit):
        print(f"complex API {what}: {value:.1f} dB (gate {limit:.0f})")
        require(value >= limit, f"complex API {what}: {value:.1f} dB < {limit}")

    # fft and ifft at the headline shape, on ESTIMATE's algorithm
    B, n = MAIN_SHAPE
    x = cplx(B, n)
    plan = plan_dft_1d(n, device=dev)
    require(plan.algorithm == "stockham_mxu", f"ESTIMATE at 2^20: {plan.describe()}")
    y = fft(x)
    gate("fft 16 x 2^20 (stockham_mxu) vs float64", snr(y, torch.fft.fft(f64(x))), 120.0)
    gate("ifft(fft(x)) 16 x 2^20", snr(ifft(y), x), 120.0)
    split = lambda: from_split(*fft_split_auto(*to_split(x)))
    gate("from_split(fft_split_auto(to_split(x))) 16 x 2^20 vs float64",
         snr(split(), torch.fft.fft(f64(x))), 120.0)
    t_api, t_split, t_lib = (time_ms(lambda: fft(x)), time_ms(split),
                             time_ms(lambda: torch.fft.fft(x)))
    print(f"time complex fft 16x2^20: fft (stockham_mxu) {t_api:.4f} ms, "
          f"from_split(fft_split_auto(to_split)) {t_split:.4f} ms, "
          f"torch.fft.fft {t_lib:.4f} ms [{card}]")
    del x, y

    # the registry's row-kernel entry: one fft_rows launch a call
    B2, n2 = ROWS_MAIN_SHAPE
    u = cplx(B2, n2)
    calls = 3
    reset_counts()
    for _ in range(calls):
        v = fft(u, algorithm="pallas_vmem")
    torch.cuda.synchronize()
    launched = {k: c for k, c in read_counts().items() if c}
    print(f"complex API fft(algorithm='pallas_vmem') 256 x 16384, {calls} calls, "
          f"launches: {launched}")
    require(launched == {"fft_rows": calls},
            f"pallas_vmem launched {launched} in {calls} calls, want fft_rows {calls} times")
    gate("pallas_vmem 256 x 16384 vs float64", snr(v, torch.fft.fft(f64(u))), 120.0)
    plain = torch.complex(*fft_vmem.fft_rows_plain(u.real.contiguous(), u.imag.contiguous()))
    gate("pallas_vmem 256 x 16384 vs fft_rows_plain", snr(v, plain), 120.0)
    print(f"time complex pallas_vmem 256x16384: {time_ms(lambda: fft(u, algorithm='pallas_vmem')):.4f}"
          f" ms, torch.fft.fft {time_ms(lambda: torch.fft.fft(u)):.4f} ms [{card}]")
    del u, v, plain

    # every registry algorithm at a size it takes
    for name, spec in build_registry().items():
        m = REGISTRY_SIZES.get(name, 4096)
        require(spec.supports(m), f"{name} does not take n={m}")
        a = cplx(REGISTRY_ROWS, m)
        b = spec.fn(a)
        t = time_ms(lambda: spec.fn(a), iters=5, inner=2, warmup=1)
        s_db = snr(b, torch.fft.fft(f64(a)))
        print(f"complex API registry {name} {REGISTRY_ROWS} x {m}: {s_db:.1f} dB, {t:.4f} ms "
              f"[{card}]")
        require(b.shape == a.shape and s_db >= 110.0, f"registry {name}: {s_db:.1f} dB")

    # the real and 2-D transforms
    Br, nr = RFFT_SHAPE
    xr = torch.randn(Br, nr, generator=gen, device=dev)
    X = rfft(xr)
    gate("rfft 8 x 2^21 vs float64", snr(X, torch.fft.rfft(xr.double())), 110.0)
    gate("irfft 8 x 2^21 vs float64", snr(irfft(X, nr), torch.fft.irfft(f64(X), nr)), 110.0)
    print(f"time complex rfft 8x2^21: {time_ms(lambda: rfft(xr)):.4f} ms, torch.fft.rfft "
          f"{time_ms(lambda: torch.fft.rfft(xr)):.4f} ms; irfft {time_ms(lambda: irfft(X, nr)):.4f}"
          f" ms, torch.fft.irfft {time_ms(lambda: torch.fft.irfft(X, nr)):.4f} ms [{card}]")
    del xr, X
    z = cplx(*FFT2_SHAPE)
    Z = fft2(z)
    gate("fft2 2048 x 2048 vs float64", snr(Z, torch.fft.fft2(f64(z))), 110.0)
    gate("ifft2 2048 x 2048 vs float64", snr(ifft2(Z), torch.fft.ifft2(f64(Z))), 110.0)
    print(f"time complex fft2 2048x2048: {time_ms(lambda: fft2(z)):.4f} ms, torch.fft.fft2 "
          f"{time_ms(lambda: torch.fft.fft2(z)):.4f} ms; ifft2 {time_ms(lambda: ifft2(Z)):.4f} ms,"
          f" torch.fft.ifft2 {time_ms(lambda: torch.fft.ifft2(Z)):.4f} ms [{card}]")
    del z, Z

    # MEASURE, with the wisdom in a temporary file
    saved = os.environ.get("FFTLAB_WISDOM_PATH")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["FFTLAB_WISDOM_PATH"] = os.path.join(tmp, "wisdom.json")
        try:
            wisdom.forget()
            t0 = time.perf_counter()
            p = plan_dft_1d(MEASURE_N, flags=Flags.MEASURE, device=dev)
            rec = wisdom.lookup(MEASURE_N, "f32")
            print(f"complex API MEASURE plan_dft_1d(2^16) in {time.perf_counter() - t0:.1f} s: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["timings_ms"].items())
                  + f"; winner {p.algorithm} [{card}]")
            require(rec["algorithm"] == p.algorithm == min(rec["timings_ms"], key=rec["timings_ms"].get),
                    f"MEASURE winner {p.algorithm}, record {rec}")
            require(rec["platform"] == "gpu" and rec["device_name"] == torch.cuda.get_device_name(0),
                    f"MEASURE record {rec}")
            xm = cplx(8, MEASURE_N)
            gate(f"MEASURE winner {p.algorithm} 8 x 2^16 vs float64",
                 snr(p.execute(xm), torch.fft.fft(f64(xm))), 110.0)
            q = plan_dft_1d(MEASURE_N, flags=Flags.WISDOM_ONLY, device=dev)
            require(q.algorithm == p.algorithm and wisdom.lookup(MEASURE_N, "f32") == rec,
                    f"WISDOM_ONLY gave {q.algorithm}, measured again or lost {rec}")
            print(f"complex API WISDOM_ONLY plan_dft_1d(2^16): {q.algorithm}, not measured again")

            B, n = MAIN_SHAPE
            sp = plan_dft_1d_split(n, flags=Flags.MEASURE, batch=B, device=dev)
            rec = wisdom.lookup(n, "f32", kind="route")
            print(f"complex API MEASURE plan_dft_1d_split(2^20, batch=16): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["timings_ms"].items())
                  + f"; winner {sp.algorithm} [{card}]")
            require(sp.algorithm in ("smem_rows", "two_pass", "three_pass"),
                    f"split MEASURE at 2^20 chose {sp.algorithm}")
            require(rec["platform"] == "gpu", f"split MEASURE record {rec}")
            pr = torch.randn(B, n, generator=gen, device=dev)
            pi = torch.randn(B, n, generator=gen, device=dev)
            got = torch.complex(*sp.execute((pr, pi)))
            gate(f"split MEASURE winner {sp.algorithm} 16 x 2^20 vs float64",
                 snr(got, torch.fft.fft(torch.complex(pr.double(), pi.double()))), 120.0)
            Bs, ns = SPLIT_TUNE_SMALL
            small = split_tuning.tune_split_route(ns, batch=Bs, device=dev)
            rec = wisdom.lookup(ns, "f32", kind="route")
            print(f"complex API MEASURE split routes 256 x 8192: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["timings_ms"].items())
                  + f"; winner {small} (static rule: smem_rows) [{card}]")
            Be, ne = SPLIT_TUNE_EDGE
            edge = split_tuning.tune_split_route(ne, batch=Be, device=dev)
            rec = wisdom.lookup(ne, "f32", kind="route")
            print(f"complex API MEASURE split routes 4 x 2^21: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["timings_ms"].items())
                  + f"; winner {edge} (static rule: two_pass) [{card}]")
        finally:
            wisdom.forget()
            if saved is None:
                os.environ.pop("FFTLAB_WISDOM_PATH", None)
            else:
                os.environ["FFTLAB_WISDOM_PATH"] = saved
    print(f"complex API phase: {time.perf_counter() - t_phase:.1f} s")


# the DSP path (phase 4f): the shapes users run the entry points at
DSP_CONV_SHAPE, DSP_CONV_TAPS = (16, 1 << 20), 1025  # m = 2^21
DSP_BLOCK_N, DSP_BLOCK_TAPS, DSP_BLOCK = 1 << 23, 129, 1024  # the serving shape
DSP_DIRECT_N, DSP_DIRECT_TAPS = 1 << 16, 129
DSP_IMAGE, DSP_KERNEL_2D = 2048, 33  # a 4096 x 4096 FFT
DSP_ROWS = (16, 1 << 20)  # fft_filter, periodogram
DSP_WELCH_WINDOW = 256
DSP_CORR_SHAPE = (16, 1 << 19)  # m = 2^20: two_pass
# the split correlations at each route's m: 8192 (smem_rows), 2^20
# (two_pass) and 2^22 (three_pass)
DSP_CORR_ROUTES = ((64, 4096), (16, 1 << 19), (2, 1 << 21))
DSP_PITCH_SHAPE, DSP_FS = (1024, 4096), 44100.0
DSP_ANALYZER_SECONDS, DSP_CHUNK = 10, 4096
# the timing protocol of the DSP entry points: 5 calls between the
# events, median of 10 (the slowest take tens of ms a call)
DSP_TIMING = {"iters": 10, "inner": 5, "warmup": 3}


def dsp_phase(dev, gen, card: str, reset_counts, read_counts) -> list:
    """Phase 4f: the complex-dtype DSP on the card, through its public
    entry points at the shapes users run them (see the module docstring).
    Every output is held against a float64 computation of the same
    function on the same float32 input (torch.fft and torch.stft in
    float64 on the card, np.convolve, and a float64 sequential average
    on the host), the pitch estimates against the port's own CPU path.
    Returns the timing cases of phase 5: (name, shape, entry point,
    library name, library call or None, bytes in and out)."""
    import contextlib
    import importlib
    import io

    import numpy as np
    import torch
    import torch.nn.functional as F

    from fftlab_torch.core.window import get_window
    from fftlab_torch.dsp import analyzer, image
    from fftlab_torch.dsp.convolution import (circular_convolution, convolve2d,
                                              direct_convolution, fft_convolution,
                                              overlap_add, overlap_save)
    from fftlab_torch.dsp.filtering import (FilterParams, FilterType, design_response,
                                            fft_filter)
    from fftlab_torch.dsp.pitch import (detect_pitch, harmonic_product_spectrum,
                                        pitch_autocorrelation, pitch_spectral_peak)
    from fftlab_torch.dsp.spectrum import (autocorrelation, autocorrelation_split, coherence,
                                           cross_correlation, cross_correlation_split,
                                           periodogram, welch_psd)
    from fftlab_torch.dsp.stft import istft, spectrogram, stft, stft_complex
    from fftlab_torch.plan.dispatch import select_split_impl

    t_phase = time.perf_counter()
    cases = []

    def reals(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def snr(got, want) -> float:
        """dB of a float32/complex64 output against its float64 reference."""
        err = (got.to(want.dtype) - want).abs().square().sum().clamp_min(1e-300)
        return float(10 * torch.log10(want.abs().square().sum() / err))

    def gate(what, got, want, limit):
        require(tuple(got.shape) == tuple(want.shape), f"dsp {what}: shape "
                f"{tuple(got.shape)}, want {tuple(want.shape)}")
        require(bool(torch.isfinite(got).all()), f"dsp {what}: non-finite output")
        s = snr(got, want)
        print(f"dsp {what}: {s:.1f} dB vs float64 (gate {limit:.0f})")
        require(s >= limit, f"dsp {what}: {s:.1f} dB < {limit}")

    def window64(size):
        return torch.from_numpy(get_window("hann", size)).to(dev)

    def stft64(x, size, hop, onesided=True):
        """float64 [frames, bins] of the whole frames (torch.stft)."""
        return torch.stft(x.double(), size, hop, window=window64(size), center=False,
                          onesided=onesided, return_complex=True).T

    def ema64(mag):
        """float64 sequential average c_t = 3/4 c_{t-1} + 1/4 m_t, c_-1 = m_0."""
        m = mag.cpu().numpy()
        out, c = np.empty_like(m), m[0]
        for t in range(len(m)):
            c = 0.75 * c + 0.25 * m[t]
            out[t] = c
        return torch.from_numpy(out).to(dev)

    def launched(fn):
        """fn() and the launches it made, by kernel."""
        before = read_counts()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def nbytes(a):
        return a.element_size() * a.numel()

    reset_counts()
    # the FFT convolutions: 16 x 2^20 real, 1025 real taps, m = 2^21
    B, n = DSP_CONV_SHAPE
    nh = DSP_CONV_TAPS
    x, h = reals(B, n), reals(nh) / math.sqrt(nh)
    L, m = n + nh - 1, 1 << (n + nh - 2).bit_length()
    want = torch.fft.irfft(torch.fft.rfft(x.double(), m) * torch.fft.rfft(h.double(), m),
                           m)[:, :L]
    gate("fft_convolution 16 x 2^20, 1025 taps", fft_convolution(x, h), want, 110.0)
    xc, hc = F.pad(x, (0, m - n)), F.pad(h, (0, m - nh))
    gate("circular_convolution 16 x 2^21", circular_convolution(xc, hc),
         F.pad(want, (0, m - L)), 110.0)
    del want
    # (every closure binds what it reads: the names are reused below)
    cases += [("fft_convolution", "16 x 2^20, 1025 taps", lambda x=x, h=h: fft_convolution(x, h),
               "torch.fft.rfft/irfft", lambda x=x, h=h, m=m, L=L: torch.fft.irfft(
                   torch.fft.rfft(x, m) * torch.fft.rfft(h, m), m)[:, :L],
               nbytes(x) + nbytes(h) + 4 * B * L),
              ("circular_convolution", "16 x 2^21", lambda: circular_convolution(xc, hc),
               "torch.fft.rfft/irfft", lambda m=m: torch.fft.irfft(
                   torch.fft.rfft(xc) * torch.fft.rfft(hc), m),
               2 * nbytes(xc) + nbytes(hc))]

    # the block convolutions at the serving shape, and the direct one
    nb, nh = DSP_BLOCK_N, DSP_BLOCK_TAPS
    s, g = reals(nb), reals(nh) / nh
    L, m = nb + nh - 1, 1 << (nb + nh - 2).bit_length()
    want = torch.fft.irfft(torch.fft.rfft(s.double(), m) * torch.fft.rfft(g.double(), m),
                           m)[:L]
    gate("overlap_save 2^23, 129 taps, block 1024", overlap_save(s, g, DSP_BLOCK), want, 110.0)
    gate("overlap_add 2^23, 129 taps, block 1024", overlap_add(s, g, DSP_BLOCK), want, 110.0)
    del want
    g_flip = torch.flip(g, (0,)).view(1, 1, nh)
    cases += [(name, "2^23, 129 taps, block 1024", lambda f=f: f(s, g, DSP_BLOCK),
               "conv1d", lambda: F.conv1d(s.view(1, 1, -1), g_flip,
                                          padding=DSP_BLOCK_TAPS - 1)[0, 0],
               nbytes(s) + nbytes(g) + 4 * L)
              for name, f in (("overlap_save", overlap_save), ("overlap_add", overlap_add))]
    d, dh = reals(DSP_DIRECT_N), reals(DSP_DIRECT_TAPS) / DSP_DIRECT_TAPS
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, outside the call
    try:
        y = direct_convolution(d, dh)
        require(torch.backends.cudnn.allow_tf32, "direct_convolution left cuDNN TF32 off")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = torch.from_numpy(np.convolve(d.double().cpu().numpy(),
                                        dh.double().cpu().numpy())).to(dev)
    gate("direct_convolution 2^16, 129 taps, cudnn.allow_tf32 True outside", y, want, 110.0)
    dh_flip = torch.flip(dh, (0,)).view(1, 1, -1)
    cases.append(("direct_convolution", "2^16, 129 taps", lambda: direct_convolution(d, dh),
                  "conv1d", lambda: F.conv1d(d.view(1, 1, -1), dh_flip,
                                             padding=DSP_DIRECT_TAPS - 1)[0, 0],
                  nbytes(d) + nbytes(dh) + 4 * (DSP_DIRECT_N + DSP_DIRECT_TAPS - 1)))

    # 2-D: 2048 x 2048 with a 33 x 33 kernel, a 4096 x 4096 FFT
    img, k2 = reals(DSP_IMAGE, DSP_IMAGE), reals(DSP_KERNEL_2D, DSP_KERNEL_2D) / DSP_KERNEL_2D
    r = DSP_IMAGE + DSP_KERNEL_2D - 1
    sz = (1 << (r - 1).bit_length(),) * 2
    want = torch.fft.irfft2(torch.fft.rfft2(img.double(), sz) * torch.fft.rfft2(k2.double(), sz),
                            sz)[:r, :r]
    gate("convolve2d 2048 x 2048, 33 x 33", convolve2d(img, k2), want, 110.0)
    del want
    cases.append(("convolve2d", "2048 x 2048, 33 x 33", lambda: convolve2d(img, k2),
                  "torch.fft.fft2", lambda r=r: torch.fft.ifft2(
                      torch.fft.fft2(img, sz) * torch.fft.fft2(k2, sz))[:r, :r].real,
                  nbytes(img) + nbytes(k2) + 4 * r * r))

    # the FFT filter and the periodogram, 16 x 2^20
    B, n = DSP_ROWS
    u = reals(B, n)
    params = FilterParams(FilterType.LOWPASS, 0.1)
    H = torch.from_numpy(design_response(n, params)).to(dev)
    gate("fft_filter 16 x 2^20", fft_filter(u, params),
         torch.fft.ifft(torch.fft.fft(u.double()) * H).real, 110.0)
    H_half = H[: n // 2 + 1].float()
    cases.append(("fft_filter", "16 x 2^20", lambda: fft_filter(u, params),
                  "torch.fft.rfft/irfft", lambda n=n: torch.fft.irfft(torch.fft.rfft(u) * H_half, n),
                  2 * nbytes(u)))
    w = window64(n)
    dbl = torch.full((n // 2 + 1,), 2.0, dtype=torch.float64, device=dev)
    dbl[0] = dbl[-1] = 1.0
    psd = torch.fft.rfft(u.double() * w).abs().square() / (n * w.square().mean()) * dbl
    gate("periodogram 16 x 2^20", periodogram(u)[1], psd, 100.0)
    del psd
    w32 = w.float()
    cases.append(("periodogram", "16 x 2^20", lambda: periodogram(u),
                  "torch.fft.rfft", lambda: torch.fft.rfft(u * w32).abs().square(),
                  nbytes(u) + 4 * B * (n // 2 + 1)))

    # the STFT family, 2^22 samples at 2048/512 and 256/128
    sig = reals(STFT_N)
    for size, hop in STFT_CASES:
        tag = f"{size}/{hop}"
        frames = (STFT_N - size) // hop + 1
        bins = size // 2 + 1
        S = stft(sig, size, hop)
        ref = stft64(sig, size, hop)
        gate(f"stft 2^22 {tag}", S, ref, 110.0)
        gate(f"stft_complex 2^22 {tag}", stft_complex(sig, size, hop),
             stft64(sig, size, hop, onesided=False), 110.0)
        back = istft(S, size, hop, length=STFT_N)
        w2 = np.asarray(get_window("hann", size)) ** 2
        energy = np.zeros((frames - 1) * hop + size)
        for j in range(size // hop):  # hop divides the frame: q diagonal shifts
            energy[j * hop:j * hop + frames * hop] += np.tile(w2[j * hop:(j + 1) * hop], frames)
        keep = torch.from_numpy(energy[:STFT_N] >= 1e-3).to(dev)
        gate(f"istft 2^22 {tag} where the window energy >= 1e-3", back[keep],
             sig.double()[keep], 110.0)
        avg = ema64(ref.abs())
        gate(f"spectrogram(averaging=4) 2^22 {tag}", spectrogram(sig, size, hop, averaging=4),
             avg, 110.0)
        wt = window64(size).float()
        S_lib = torch.stft(sig, size, hop, window=wt, center=True, return_complex=True)
        out_c, out_r = 8 * frames * bins, 4 * frames * bins
        cases += [("stft", f"2^22 {tag}", lambda size=size, hop=hop: stft(sig, size, hop),
                   "torch.stft", lambda size=size, hop=hop, wt=wt: torch.stft(
                       sig, size, hop, window=wt, center=False, return_complex=True),
                   nbytes(sig) + out_c),
                  ("stft_complex", f"2^22 {tag}",
                   lambda size=size, hop=hop: stft_complex(sig, size, hop), "torch.stft",
                   lambda size=size, hop=hop, wt=wt: torch.stft(
                       sig, size, hop, window=wt, center=False, onesided=False,
                       return_complex=True), nbytes(sig) + 2 * out_c),
                  ("istft", f"2^22 {tag}",
                   lambda S=S, size=size, hop=hop: istft(S, size, hop, length=STFT_N),
                   "torch.istft (center=True)", lambda size=size, hop=hop, wt=wt, S_lib=S_lib:
                   torch.istft(S_lib, size, hop, window=wt, center=True, length=STFT_N),
                   out_c + nbytes(sig)),
                  ("spectrogram(averaging=4)", f"2^22 {tag}",
                   lambda size=size, hop=hop: spectrogram(sig, size, hop, averaging=4),
                   "torch.stft().abs()", lambda size=size, hop=hop, wt=wt: torch.stft(
                       sig, size, hop, window=wt, center=False, return_complex=True).abs(),
                   nbytes(sig) + out_r)]
        if (size, hop) == STFT_CASES[0]:
            avg_main = avg
        del S, ref, back, keep, avg, S_lib

    # Welch and coherence, 2^22 samples, window 256
    ws = DSP_WELCH_WINDOW
    sig2 = 0.6 * sig + 0.4 * reals(STFT_N)
    X64, Y64 = stft64(sig, ws, ws // 2), stft64(sig2, ws, ws // 2)
    dbl = torch.full((ws // 2 + 1,), 2.0, dtype=torch.float64, device=dev)
    dbl[0] = dbl[-1] = 1.0
    psd = X64.abs().square().mean(0) / (ws * window64(ws).square().mean()) * dbl
    gate("welch_psd 2^22, window 256", welch_psd(sig, window_size=ws)[1], psd, 100.0)
    coh_want = ((X64.conj() * Y64).mean(0).abs().square()
                / (X64.abs().square().mean(0) * Y64.abs().square().mean(0)))
    coh = coherence(sig, sig2, window_size=ws)[1]
    diff = float((coh.double() - coh_want).abs().max())
    print(f"dsp coherence 2^22, window 256: max |error| {diff:.3g} vs float64 (gate 1e-4)")
    require(diff <= 1e-4, f"dsp coherence: max error {diff:.3g} > 1e-4")
    del X64, Y64
    w256 = window64(ws).float()
    lib_seg = lambda v: torch.stft(v, ws, ws // 2, window=w256, center=False,
                                   return_complex=True)
    cases += [("welch_psd", "2^22, window 256", lambda: welch_psd(sig, window_size=ws),
               "torch.stft", lambda: lib_seg(sig).abs().square().mean(-1), nbytes(sig) + 4 * 129),
              ("coherence", "2^22, window 256", lambda: coherence(sig, sig2, window_size=ws),
               "torch.stft", lambda: (lib_seg(sig).conj() * lib_seg(sig2)).mean(-1).abs(),
               2 * nbytes(sig) + 4 * 129)]

    # the correlations, 16 x 2^19 (m = 2^20), the complex ones and the
    # split pair; the split pair also at the other routes' m
    for Bc, nc in DSP_CORR_ROUTES:
        a, b = reals(Bc, nc), reals(Bc, nc)
        mc = 2 * nc
        route = select_split_impl(mc, Bc)
        X, Y = torch.fft.rfft(a.double(), mc), torch.fft.rfft(b.double(), mc)
        r = torch.fft.irfft(X.abs().square(), mc)[:, :nc]
        auto64 = r / r[:, :1]
        rc = torch.fft.irfft(X.conj() * Y, mc)
        cross64 = torch.cat([rc[:, mc - (nc - 1):], rc[:, :nc]], dim=-1)
        del X, Y, r, rc
        label = f"{Bc} x 2^{nc.bit_length() - 1}"
        for name, fn, want in (("autocorrelation_split", lambda: autocorrelation_split(a),
                                auto64),
                               ("cross_correlation_split",
                                lambda: cross_correlation_split(a, b), cross64)):
            got, counts = launched(fn)
            print(f"dsp {name} {label} (m = 2^{mc.bit_length() - 1}, route {route}) "
                  f"launches: {counts}")
            kernels = {"smem_rows": ("fft_rows",),
                       "two_pass": ("fourstep_pass1", "fourstep_pass2"),
                       "three_pass": ("threestep_pass_a", "threestep_pass_b",
                                      "threestep_pass_c")}[route]
            require(counts == dict.fromkeys(kernels, 2),
                    f"{name} at m = {mc} launched {counts}, want two of each of {kernels}")
            gate(f"{name} {label}", got, want, 100.0)
        if (Bc, nc) == DSP_CORR_SHAPE:
            gate(f"autocorrelation {label}", autocorrelation(a), auto64, 100.0)
            gate(f"cross_correlation {label}", cross_correlation(a, b), cross64, 100.0)
            lib_auto = lambda a=a, nc=nc, mc=mc: torch.fft.irfft(
                torch.fft.rfft(a, mc).abs().square(), mc)[:, :nc]
            lib_cross = lambda a=a, b=b, mc=mc: torch.fft.irfft(
                torch.fft.rfft(a, mc).conj() * torch.fft.rfft(b, mc), mc)
            out_x = 4 * Bc * (2 * nc - 1)
            cases += [("autocorrelation", label, lambda a=a: autocorrelation(a),
                       "torch.fft.rfft/irfft", lib_auto, 2 * nbytes(a)),
                      ("autocorrelation_split", label, lambda a=a: autocorrelation_split(a),
                       "torch.fft.rfft/irfft", lib_auto, 2 * nbytes(a)),
                      ("cross_correlation", label, lambda a=a, b=b: cross_correlation(a, b),
                       "torch.fft.rfft/irfft", lib_cross, 2 * nbytes(a) + out_x),
                      ("cross_correlation_split", label,
                       lambda a=a, b=b: cross_correlation_split(a, b),
                       "torch.fft.rfft/irfft", lib_cross, 2 * nbytes(a) + out_x)]
        del auto64, cross64

    # pitch: 1024 frames of 4096 at 44.1 kHz, against the port's CPU path
    Bp, n_p = DSP_PITCH_SHAPE
    t = torch.arange(n_p, dtype=torch.float64, device=dev) / DSP_FS
    f0 = torch.linspace(100.0, 1000.0, Bp, dtype=torch.float64, device=dev)[:, None]
    frames = (torch.sin(2 * math.pi * f0 * t) + 0.5 * torch.sin(4 * math.pi * f0 * t)
              + 0.25 * torch.sin(6 * math.pi * f0 * t)
              + 0.01 * reals(Bp, n_p).double()).float()
    frames_host = frames.cpu()
    for name, fn in (("pitch_spectral_peak", pitch_spectral_peak),
                     ("harmonic_product_spectrum", harmonic_product_spectrum),
                     ("pitch_autocorrelation", pitch_autocorrelation)):
        got, want = fn(frames, DSP_FS).cpu(), fn(frames_host, DSP_FS)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        print(f"dsp {name} 1024 x 4096: max relative difference from the CPU path "
              f"{rel:.3g} (gate 1e-3)")
        require(got.shape == (Bp,) and rel <= 1e-3, f"dsp {name}: {rel:.3g} from CPU")
        cases.append((name, "1024 x 4096", lambda fn=fn: fn(frames, DSP_FS), None, None,
                      nbytes(frames) + 4 * Bp))
    one = frames[Bp // 3]
    got, want = detect_pitch(one, DSP_FS), detect_pitch(frames_host[Bp // 3], DSP_FS)
    print(f"dsp detect_pitch one frame: {got['pitch']:.4f} Hz {got['note']} "
          f"(CPU {want['pitch']:.4f} Hz {want['note']})")
    require(got["note"] == want["note"]
            and abs(got["pitch"] - want["pitch"]) <= 1e-3 * want["pitch"],
            f"dsp detect_pitch {got} vs CPU {want}")
    cases.append(("detect_pitch", "one frame of 4096", lambda: detect_pitch(one, DSP_FS),
                  None, None, nbytes(one)))

    # the analyzer: 10 s of 44.1 kHz in 4096-sample chunks, on the card and
    # on the CPU; spectrogram_batch on 2^22 samples
    total = int(DSP_ANALYZER_SECONDS * DSP_FS)
    tt_ = np.arange(total) / DSP_FS
    phase = 2 * np.pi * np.cumsum(440.0 + 400.0 * np.sin(2 * np.pi * 0.5 * tt_)) / DSP_FS
    stream = (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)).astype(
        np.float32)
    cfg = analyzer.AnalyzerConfig()
    on_card, on_host = analyzer.RealtimeAnalyzer(cfg), analyzer.RealtimeAnalyzer(cfg, device="cpu")

    def feed():
        calls = 0
        for i in range(0, total, DSP_CHUNK):
            chunk = stream[i:i + DSP_CHUNK]
            calls += on_card.process(chunk) is not None
            on_host.process(chunk)
            require(np.array_equal(on_card._tail, on_host._tail), "analyzer tail differs")
        return calls

    calls, counts = launched(feed)
    print(f"dsp RealtimeAnalyzer 10 s in {-(-total // DSP_CHUNK)} chunks of 4096: "
          f"{calls} spectra, launches: {counts}")
    require(counts == {"stft_frames": calls}, f"analyzer launched {counts} in {calls} calls")
    # the stream's frames are the whole signal's: its average is the last
    # of the float64 average over them
    ref = ema64(stft64(torch.from_numpy(stream).to(dev), cfg.fft_size, cfg.hop).abs())
    require(len(ref) == (total - cfg.fft_size) // cfg.hop + 1, f"{len(ref)} frames")
    gate("RealtimeAnalyzer average after 10 s", torch.from_numpy(on_card._avg).to(dev),
         ref[-1], 110.0)
    require([round(p.bin) for p in on_card.peaks()] == [round(p.bin) for p in on_host.peaks()],
            "analyzer peaks differ from the CPU path")
    del ref
    chunk = torch.from_numpy(stream[:DSP_CHUNK]).to(dev)
    cases.append(("RealtimeAnalyzer.process", "4096-sample chunk",
                  lambda chunk=chunk: on_card.process(chunk), None, None,
                  4 * DSP_CHUNK + 4 * 1025))
    batch, counts = launched(lambda: on_card.spectrogram_batch(sig))
    print(f"dsp spectrogram_batch 2^22: launches {counts}")
    require(counts == {"stft_frames": 1}, f"spectrogram_batch launched {counts}")
    gate("spectrogram_batch 2^22 2048/512", batch, avg_main, 110.0)
    wt = window64(cfg.fft_size).float()
    cases.append(("spectrogram_batch", "2^22 2048/512", lambda: on_card.spectrogram_batch(sig),
                  "torch.stft().abs()", lambda wt=wt: torch.stft(
                      sig, 2048, 512, window=wt, center=False, return_complex=True).abs(),
                  nbytes(sig) + nbytes(batch)))
    del batch, avg_main

    # images: 2048 x 2048 low- and high-pass, ideal and gaussian, edges and
    # the log-magnitude spectrum
    F64 = torch.fft.fft2(img.double())
    side = DSP_IMAGE
    for name, kind, cutoff, build in (
            ("lowpass_filter_image", "ideal", side / 10, image.ideal_lowpass_mask),
            ("lowpass_filter_image", "gaussian", side / 10, image.gaussian_lowpass_mask),
            ("highpass_filter_image", "ideal", side / 8, image.ideal_highpass_mask),
            ("highpass_filter_image", "gaussian", side / 8, image.gaussian_highpass_mask)):
        fn = getattr(image, name)
        M = torch.from_numpy(build(side, side, cutoff)).to(dev)
        gate(f"{name} {kind} 2048 x 2048", fn(img, cutoff, kind),
             torch.fft.ifft2(F64 * M).real, 110.0)
        M32 = M.to(torch.complex64)
        cases.append((f"{name}({kind})", "2048 x 2048",
                      lambda fn=fn, kind=kind, cutoff=cutoff: fn(img, cutoff, kind),
                      "torch.fft.fft2", lambda M32=M32: torch.fft.ifft2(
                          torch.fft.fft2(img) * M32).real, 2 * nbytes(img)))
    M = torch.from_numpy(image.ideal_highpass_mask(side, side, side / 8)).to(dev)
    gate("detect_edges 2048 x 2048", image.detect_edges(img),
         torch.fft.ifft2(F64 * M).real.abs(), 110.0)
    gate("log_magnitude_spectrum 2048 x 2048", image.log_magnitude_spectrum(img),
         torch.log1p(torch.fft.fftshift(F64).abs()), 110.0)
    del F64
    M32 = M.to(torch.complex64)
    cases += [("detect_edges", "2048 x 2048", lambda: image.detect_edges(img),
               "torch.fft.fft2", lambda: torch.fft.ifft2(torch.fft.fft2(img) * M32).real.abs(),
               2 * nbytes(img)),
              ("log_magnitude_spectrum", "2048 x 2048", lambda: image.log_magnitude_spectrum(img),
               "torch.fft.fft2", lambda: torch.log1p(torch.fft.fftshift(
                   torch.fft.fft2(img)).abs()), 2 * nbytes(img))]

    torch.cuda.synchronize()
    path = {k: c for k, c in read_counts().items() if c}
    print(f"DSP path launches: {path}")
    for k in ("stft_frames", "fft_rows", "fourstep_pass1", "fourstep_pass2",
              "threestep_pass_a", "threestep_pass_b", "threestep_pass_c"):
        require(path.get(k, 0) > 0, f"kernel {k} was not launched on the DSP path")

    # the six demos, each once on the card with its default arguments
    for demo in ("spectrum", "convolution", "filter", "image", "pitch", "analyzer"):
        saved, sys.argv = sys.argv, ["prog"]
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                importlib.import_module(f"fftlab_torch.cli.{demo}").main()
        finally:
            sys.argv = saved
        lines = out.getvalue().splitlines()
        print(f"dsp demo {demo} on the card: {len(lines)} lines in "
              f"{time.perf_counter() - t0:.1f} s; last: {lines[-1].strip() if lines else ''}")
        require(len(lines) > 2, f"demo {demo} printed {len(lines)} lines")
    print(f"DSP phase: {time.perf_counter() - t_phase:.1f} s")
    return cases


# the single-card edges (phase 4g): serving at bench.py serving_filter's
# 2^23 samples, a 48 kHz mono PCM16 WAV, through cli/serve at its defaults
# (lowpass at 2 kHz, 257 taps, 64K chunks); its np.convolve gate reads a
# 128K prefix, and the CPU run of the same demo a 2^20 prefix
SERVE_N, SERVE_FS = 1 << 23, 48000
SERVE_GATE_PREFIX, SERVE_CPU_PREFIX = 1 << 17, 1 << 20
SERVE_GATE_DB, SERVE_TONE_DB = 100.0, 0.1
BIGFFT_N = 1 << 20
LOWPREC_SHAPE = (16, 1 << 20)
LOWPREC_F32_DB, LOWPREC_FLOOR_DB = 120.0, 20.0
# the harness: every registry algorithm whose call is a few whole-array
# ops; the eager recursions (radix4, split_radix, recursive, iterative)
# take 0.1-0.5 s a call at 16384, hundreds of calls in the harness's
# protocol, and are timed at 64 rows in phase 4e
HARNESS_SIZES = (1024, 16384)
HARNESS_ALGOS = ("radix2_dit", "radix2_dif", "bluestein", "mixed_radix", "stockham_mxu",
                 "pallas_vmem", "four_step")
TRACE_DIR = os.path.join("chiprun_out", "edges_trace")


def edges_phase(dev, gen, card: str, reset_counts, read_counts) -> None:
    """Phase 4g: the native runtime, the serving demo, bigfft, the
    reduced-precision modes, the harness and the profiler trace, on the
    card (see the module docstring). Every gate raises SmokeFailure."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from fftlab_torch.algos.lowprec import PRECISIONS, fft_split_lowprec, snr_vs_oracle
    from fftlab_torch.bench.harness import benchmark_suite, print_table
    from fftlab_torch.cli import bigfft, parse, serve
    from fftlab_torch.kernels.os_filter_vmem import run_os_filter
    from fftlab_torch.native import lib as native_lib
    from fftlab_torch.native.wav import write_wav
    from fftlab_torch.utils.trace import profiler_trace

    t_phase = time.perf_counter()

    # a. the native library, built with g++ from native/ into its own directory
    so = native_lib.library_path()
    fresh = not so.is_file()
    t0 = time.perf_counter()
    loaded = native_lib.load_native_lib()
    dt = time.perf_counter() - t0
    require(loaded._name == str(so), f"native library loaded from {loaded._name}, not {so}")
    print(f"edges native: {'built with g++ in' if fresh else 'found, loaded in'} {dt:.2f} s; "
          f"fftlab_torch.native loaded from {os.path.relpath(so)}")

    # b. serving: two tones and noise at 48 kHz, from the seed, written by
    # the port's writer, served by cli/serve at its defaults
    rng = np.random.default_rng(int(gen.initial_seed()))
    t = np.arange(SERVE_N) / SERVE_FS
    sig = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 6000 * t)
           + 0.05 * rng.standard_normal(SERVE_N)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        wav_in, wav_out = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        write_wav(wav_in, sig, SERVE_FS)
        print(f"edges serve input: {SERVE_N} samples at {SERVE_FS} Hz "
              f"({SERVE_N / SERVE_FS:.1f} s, {os.path.getsize(wav_in)} bytes)")
        args = parse(serve.build_parser(), ["--in", wav_in, "--out", wav_out])
        chunks = -(-SERVE_N // args.chunk)
        reset_counts()
        served = serve.run(args)
        torch.cuda.synchronize()
        path = {k: c for k, c in read_counts().items() if c}
        print(f"edges serve path launches: {path} ({chunks} chunks)")
        require(path == {"os_filter": chunks},
                f"serve launched {path}, want os_filter once per chunk ({chunks})")
        # the first run built the plan's tables and warmed the path: the
        # rate is the second run's, the time split the third's
        seconds = serve.run(args).seconds
        timers = {}
        t0 = time.perf_counter()
        serve.run(args, timers)
        wall_spans = time.perf_counter() - t0
    plan, audio, out = served.plan, served.audio, served.filtered
    require(out.shape == audio.shape and bool(np.isfinite(out).all()),
            f"serve output shape {out.shape} or non-finite values")
    rate = SERVE_N / seconds / 1e6
    print(f"edges serve: {plan.describe()}; ring -> stream -> host {seconds * 1e3:.1f} ms "
          f"(first run {served.seconds * 1e3:.1f} ms), "
          f"{rate:.1f} Msamples/s, {rate * 1e6 / SERVE_FS:.0f}x realtime [{card}]")
    split = ", ".join(f"{k} {v.total_s * 1e3:.1f} ms ({v.total_s / wall_spans:.1%})"
                      for k, v in timers.items())
    print(f"edges serve spans ({wall_spans * 1e3:.1f} ms with a sync after each span): "
          f"{split} [{card}]")
    keep = plan.nh - 1
    buf = torch.zeros(args.chunk + keep, device=dev)
    kernel_ms = time_ms(lambda: run_os_filter(buf, torch.zeros_like(buf), plan._Kr, plan._Ki,
                                              plan.nh), graph=True)
    share = chunks * kernel_ms / (seconds * 1e3)
    print(f"edges serve kernel: os_filter {kernel_ms:.4f} ms a chunk (graph), {chunks} chunks, "
          f"{share:.2%} of the loop's wall time [{card}]")
    ref = np.convolve(audio[:SERVE_GATE_PREFIX].astype(np.float64),
                      plan.h.astype(np.float64))[:SERVE_GATE_PREFIX]
    got = out[:SERVE_GATE_PREFIX].astype(np.float64)
    gate_db = float(10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2)))
    print(f"edges serve stream vs float64 np.convolve on {SERVE_GATE_PREFIX} samples: "
          f"{gate_db:.1f} dB (gate {SERVE_GATE_DB:.0f})")
    require(gate_db >= SERVE_GATE_DB, f"serve stream {gate_db:.1f} dB < {SERVE_GATE_DB}")
    cpu_args = parse(serve.build_parser(), ["--device", "cpu"])
    cpu_out = serve.stream_through_ring(serve.make_plan(cpu_args, served.fs),
                                        audio[:SERVE_CPU_PREFIX], cpu_args.chunk)
    att_card = serve.tone_attenuations(audio, out, served.fs, dev)
    att_cpu = serve.tone_attenuations(audio, cpu_out, served.fs, "cpu")
    for tone in serve.TONES:
        print(f"edges serve {tone:.0f} Hz: card {att_card[tone]:+.3f} dB, CPU "
              f"{att_cpu[tone]:+.3f} dB")
        require(abs(att_card[tone] - att_cpu[tone]) <= SERVE_TONE_DB,
                f"serve {tone} Hz: card {att_card[tone]:.3f} dB vs CPU {att_cpu[tone]:.3f}")

    # c. bigfft: the two-pass pair at 1 x 2^20, the split convolution
    # (m = 32768: the two-pass sandwich), and the demo itself
    xr = torch.randn(1, BIGFFT_N, generator=gen, device=dev)
    xi = torch.randn(1, BIGFFT_N, generator=gen, device=dev)
    reset_counts()
    snr = bigfft.two_pass_snr(xr, xi)
    path = {k: c for k, c in read_counts().items() if c}
    print(f"edges bigfft two-pass 1 x 2^{BIGFFT_N.bit_length() - 1}: {snr:.1f} dB vs float64, "
          f"launches {path}")
    require(path == {"fourstep_pass1": 1, "fourstep_pass2": 1},
            f"bigfft two-pass launched {path}")
    require(snr >= GATE_ORACLE_DB["two_pass"], f"bigfft two-pass {snr:.1f} dB")
    h = (torch.randn(bigfft.CONV_TAPS, generator=gen, device=dev) / bigfft.CONV_TAPS)
    reset_counts()
    err = bigfft.convolution_error(xr[0, : bigfft.CONV_N], h.cpu().numpy())
    path = {k: c for k, c in read_counts().items() if c}
    print(f"edges bigfft fft_convolution_split {bigfft.CONV_N} x {bigfft.CONV_TAPS}: max err "
          f"{err:.2e} vs np.convolve, launches {path}")
    require(err <= 1e-4, f"bigfft convolution max err {err:.2e}")
    require(path == SANDWICH_LAUNCHES, f"bigfft convolution launched {path}")
    saved, sys.argv = sys.argv, ["prog"]
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            bigfft.main()
    finally:
        sys.argv = saved
    lines = text.getvalue().splitlines()
    print(f"edges bigfft demo on the card: {len(lines)} lines; "
          + "; ".join(line.strip() for line in lines[-2:]))

    # d. the reduced-precision modes at 16 x 2^20 through fft_split
    B, n = LOWPREC_SHAPE
    xr = torch.randn(B, n, generator=gen, device=dev)
    xi = torch.randn(B, n, generator=gen, device=dev)
    want = torch.fft.fft(torch.complex(xr.double(), xi.double()))
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    snrs = {}
    for mode in PRECISIONS:
        yr, yi = fft_split_lowprec(xr, xi, mode=mode)
        err = (torch.complex(yr.double(), yi.double()) - want).abs().square().sum()
        snrs[mode] = float(10 * torch.log10(want.abs().square().sum() / err))
        t_mode = time_ms(lambda: fft_split_lowprec(xr, xi, mode=mode), **DSP_TIMING)
        print(f"edges lowprec {mode} ({PRECISIONS[mode]}) {B} x 2^{n.bit_length() - 1}: "
              f"{snrs[mode]:.1f} dB vs float64, {t_mode:.4f} ms [{card}]")
    after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    require(after == before, f"lowprec left the matmul setting at {after}, was {before}")
    require(snrs["f32"] >= LOWPREC_F32_DB, f"lowprec f32 {snrs['f32']:.1f} dB")
    require(snrs["f32"] >= snrs["f32x3"] >= snrs["bf16"] > LOWPREC_FLOOR_DB,
            f"lowprec modes out of order: {snrs}")
    rows = snr_vs_oracle(device=dev)
    print("edges lowprec snr_vs_oracle 2 x 4096: "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in rows.items()))
    require("q15" in rows, "snr_vs_oracle has no q15 row")

    # e. the harness and a profiler trace
    results = benchmark_suite(HARNESS_SIZES, HARNESS_ALGOS, device=dev)
    print(print_table(results))
    bad = [(r.algorithm, r.n) for r in results if not r.roundtrip_ok]
    require(not bad, f"harness round trip failed for {bad}")
    with profiler_trace(TRACE_DIR) as prof:
        serve.stream_through_ring(plan, audio[: 4 * args.chunk], args.chunk)
        torch.cuda.synchronize()
    trace = os.path.join(TRACE_DIR, "trace.json")
    size = os.path.getsize(trace) if os.path.isfile(trace) else 0
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    print(f"edges profiler trace: {trace}, {size} bytes; device time in it "
          f"{device_us / 1e3:.4f} ms")
    require(size > 0, f"profiler_trace wrote no trace at {trace}")
    print(f"edges phase: {time.perf_counter() - t_phase:.1f} s")


# the sharded paths (phase 4h), at the main paths' sizes: one 2^24
# transform (bench.py fft_16m_single; n1 = n2 = 4096, split over 4 ranks
# as 1024 rows each), FilterPlan at the serving shape (2^23 samples, two
# planes, 129 taps), 2048^2 for the 2-D transforms, 64 blocks of 16384
# for PP, 2^22 samples for Welch (256-point segments) and the STFT
# (2048/512), 4 channels of 2^20 samples for the dp x sp filterbank
DIST_N = 1 << 24
DIST_CHUNKS = 4
DIST_FFT2 = (2048, 2048)
DIST_PP = (64, 16384)
DIST_SIGNAL_N = 1 << 22
DIST_WELCH = 256
DIST_STFT = (2048, 512)
DIST_BANK = (4, 1 << 20)
DIST_RANKS = 4
DIST_SEAM = 256  # samples each side of a shard boundary the seam gates read
DIST_TIMEOUT_S = 120  # the four gloo ranks of (b), CUDA start-up included
DIST_C2C_DB, DIST_SPECTRUM_DB, DIST_FIR_DB, DIST_SAME_DB = 120.0, 110.0, 100.0, 110.0


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from fftlab_torch.kernels import (fft_vmem, fourstep_vmem, os_filter_vmem, rfft_vmem,
                                      stage_fused, stft_vmem, threestep_vmem)

    for counts in (fft_vmem.LAUNCHES, fourstep_vmem.LAUNCHES, os_filter_vmem.LAUNCHES,
                   rfft_vmem.LAUNCHES, stft_vmem.LAUNCHES, threestep_vmem.LAUNCHES,
                   stage_fused.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    """Every kernel wrapper's launches since the last reset."""
    from fftlab_torch.kernels import (fft_vmem, fourstep_vmem, os_filter_vmem, rfft_vmem,
                                      stage_fused, stft_vmem, threestep_vmem)

    return {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES, **os_filter_vmem.LAUNCHES,
            **rfft_vmem.LAUNCHES, **stft_vmem.LAUNCHES, **threestep_vmem.LAUNCHES,
            **stage_fused.LAUNCHES}


@contextlib.contextmanager
def kernel_shapes(log: dict):
    """While open, each `fft_rows` launch appends [B, n, direction, scale]
    to log["fft_rows"] and each `os_filter` launch [C, n, fft_size, nh] to
    log["os_filter"]: the shapes a path gives the kernels, which main
    holds against the plain versions. The wrappers still launch and count
    themselves; their callers reach them through their modules, so every
    launch passes through here (dist_calls checks that)."""
    from fftlab_torch.kernels import fft_vmem, os_filter_vmem

    rows, frames = fft_vmem.fft_rows, os_filter_vmem.os_filter

    def rows_logged(xr, xi, direction=1, scale=1.0):
        log["fft_rows"].append([*xr.shape, int(direction), float(scale)])
        return rows(xr, xi, direction, scale)

    def frames_logged(xr, xi, hr, hi, nh):
        log["os_filter"].append([*xr.shape, int(hr.shape[-1]), int(nh)])
        return frames(xr, xi, hr, hi, nh)

    fft_vmem.fft_rows, os_filter_vmem.os_filter = rows_logged, frames_logged
    try:
        yield log
    finally:
        fft_vmem.fft_rows, os_filter_vmem.os_filter = rows, frames


def snr(got, want) -> float:
    """SNR in dB of `got` against `want` (tensors or arrays, real or
    complex, or (re, im) pairs of tensors), in float64."""
    import numpy as np
    import torch

    def c128(a):
        if isinstance(a, (tuple, list)):
            return torch.complex(c128(a[0]).real, c128(a[1]).real)
        a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        return a.to(torch.complex128)

    g, w = c128(got), c128(want)
    w = w.to(g.device)
    den = (g - w).abs().square().sum().clamp_min(1e-300)
    return float(10 * torch.log10(w.abs().square().sum() / den))


def dist_inputs(dev, seed: int) -> dict:
    """The sharded paths' inputs, from the seed, the same on every rank."""
    import numpy as np
    import torch

    from fftlab_torch.core.window import hann

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    rng = np.random.default_rng(seed)
    B, nb = DIST_PP
    return {
        "xr": r(DIST_N), "xi": r(DIST_N), "hr": r(DIST_N), "hi": r(DIST_N),
        "fa": r(SERVING_N), "fb": r(SERVING_N),
        "h": (rng.standard_normal(SERVING_TAPS) / np.sqrt(SERVING_TAPS)).astype(np.float32),
        "ar": r(*DIST_FFT2), "ai": r(*DIST_FFT2),
        "br": r(B, nb), "bi": r(B, nb), "pr": r(nb), "pi": r(nb),
        "w": torch.as_tensor(hann(nb), dtype=torch.float32, device=dev),
        "s": r(DIST_SIGNAL_N),
        "bank": r(*DIST_BANK),
        "bank_h": (rng.standard_normal((DIST_BANK[0], SERVING_TAPS))
                   / np.sqrt(SERVING_TAPS)).astype(np.float32),
    }


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def dist_meshes(world: int, backend: str, device_type: str) -> dict:
    """The meshes of the sharded paths: 1-D over every rank, and 2-D
    (2, world/2) or (1, 1)."""
    from fftlab_torch.dist import make_mesh, make_mesh_1d

    two = (2, world // 2) if world > 1 else (1, 1)
    kw = dict(device_type=device_type, backend=backend)
    return {"tp": make_mesh_1d("tp", **kw), "ab": make_mesh(two, ("a", "b"), **kw),
            "dpsp": make_mesh({"dp": two[0], "sp": two[1]}, **kw),
            "pp": make_mesh_1d("pp", **kw)}


def dist_calls(inp: dict, meshes: dict):
    """Each sharded entry point once on the inputs, with the launch counts
    set to 0 just before it and read just after: (whole outputs, launches
    by call, the shapes of every `fft_rows` and `os_filter` launch,
    `kernel_shapes`)."""
    import torch

    from fftlab_torch.core.types import INVERSE
    from fftlab_torch.dist import (fft2_sharded_split, four_step_fft_sharded_split, gather,
                                   pp_spectral_pipeline_split, stft_sharded,
                                   tp_spectral_filter_split, welch_psd_sharded)
    from fftlab_torch.dist.fft2_mesh2d import fft2_mesh2d_split
    from fftlab_torch.dist.overlap_save_split import overlap_save_filterbank_sharded_split
    from fftlab_torch.plan.api import plan_dft_1d_sharded
    from fftlab_torch.plan.filter_plan import FilterPlan

    tp, ab, dpsp, pp = meshes["tp"], meshes["ab"], meshes["dpsp"], meshes["pp"]
    x = (inp["xr"], inp["xi"])
    out, launches = {}, {}

    def call(name, fn):
        sync(x[0].device)
        reset_counts()
        out[name] = fn()
        sync(x[0].device)
        launches[name] = {k: c for k, c in read_counts().items() if c}

    whole = lambda pair, mesh, axis, dim: tuple(gather(t, mesh, axis, dim) for t in pair)
    shapes = {"fft_rows": [], "os_filter": []}
    with kernel_shapes(shapes):
        call("four_step", lambda: four_step_fft_sharded_split(*x, tp, "tp"))
        call("four_step_chunks", lambda: four_step_fft_sharded_split(*x, tp, "tp",
                                                                     chunks=DIST_CHUNKS))
        call("four_step_block", lambda: whole(four_step_fft_sharded_split(
            *x, tp, "tp", flatten=False), tp, "tp", -1))
        call("four_step_inverse", lambda: four_step_fft_sharded_split(
            *out["four_step"], tp, "tp", direction=INVERSE))
        call("plan", lambda: plan_dft_1d_sharded(DIST_N, tp, "tp").execute(torch.complex(*x)))
        call("filter_plan", lambda: whole(FilterPlan(inp["h"], mesh=tp, time_axis="tp")(
            inp["fa"], inp["fb"]), tp, "tp", -1))
        call("fft2", lambda: whole(fft2_sharded_split(inp["ar"], inp["ai"], tp, "tp"),
                                   tp, "tp", 0))
        call("fft2_mesh2d", lambda: fft2_mesh2d_split(inp["ar"], inp["ai"], ab, "a", "b"))
        call("tp", lambda: tp_spectral_filter_split(*x, inp["hr"], inp["hi"], tp, "tp",
                                                    flatten=True))
        call("pp", lambda: pp_spectral_pipeline_split(inp["br"], inp["bi"], inp["pr"],
                                                      inp["pi"], pp, "pp", window=inp["w"]))
        call("welch", lambda: welch_psd_sharded(inp["s"], tp, "tp",
                                                window_size=DIST_WELCH)[1])
        call("stft", lambda: gather(stft_sharded(inp["s"], tp, "tp", *DIST_STFT),
                                    tp, "tp", -2))
        call("filterbank", lambda: gather(gather(overlap_save_filterbank_sharded_split(
            inp["bank"], inp["bank_h"], dpsp), dpsp, "sp", -1), dpsp, "dp", 0))
    for kernel, logged in shapes.items():
        n_launched = sum(got.get(kernel, 0) for got in launches.values())
        require(len(logged) == n_launched,
                f"{kernel}: {n_launched} launches, {len(logged)} of them logged")
    return out, launches, shapes


def dist_launches_wanted(p: int, rank: int) -> dict:
    """The kernel launches each call makes on a rank of p: the row FFTs of
    1024..16384 points are `fft_rows`, the overlap-save blocks
    `os_filter`; the complex plan, the 2-D mesh's 32- and 64-point passes,
    Welch and the STFT run tensor ops."""
    B = DIST_PP[0]
    pp = {"fft_rows": 2 * B} if p == 1 else (
        {"fft_rows": B + p - 1} if rank in (1, p - 1) else {})
    return {"four_step": {"fft_rows": 2}, "four_step_chunks": {"fft_rows": 1 + DIST_CHUNKS},
            "four_step_block": {"fft_rows": 2}, "four_step_inverse": {"fft_rows": 2},
            "plan": {}, "filter_plan": {"os_filter": 1}, "fft2": {"fft_rows": 2},
            "fft2_mesh2d": {}, "tp": {"fft_rows": 4}, "pp": pp, "welch": {}, "stft": {},
            "filterbank": {"os_filter": DIST_BANK[0] // (2 if p > 1 else 1)}}


def fir_window(x, h, start: int, stop: int):
    """float64 np.convolve(x, h)[start:stop], from the samples it reads."""
    import numpy as np

    lo = max(start - len(h) + 1, 0)
    y = np.convolve(np.asarray(x[lo:stop], np.float64), np.asarray(h, np.float64))
    return y[start - lo:stop - lo]


def dist_oracles(inp: dict) -> dict:
    """float64 references of the sharded calls, on the card (torch.fft on
    complex128 and np.convolve, used as oracles only)."""
    import numpy as np
    import torch

    from fftlab_torch.core.window import hann, power_gain

    c = lambda re, im: torch.complex(re.double(), im.double())
    X = torch.fft.fft(c(inp["xr"], inp["xi"]))
    size, hop = DIST_STFT
    s = inp["s"].double()
    frames = torch.nn.functional.pad(s, (0, size)).unfold(0, size, hop)[:DIST_SIGNAL_N // hop]
    hw = torch.as_tensor(hann(size), device=s.device)
    ww = torch.as_tensor(hann(DIST_WELCH), device=s.device)
    segs = s.unfold(0, DIST_WELCH, DIST_WELCH // 2) * ww
    dbl = torch.full((DIST_WELCH // 2 + 1,), 2.0, dtype=torch.float64, device=s.device)
    dbl[0] = dbl[-1] = 1.0
    psd = (torch.fft.rfft(segs).abs().square().mean(0) * dbl
           / (DIST_WELCH * power_gain(hann(DIST_WELCH))))
    blocks = c(inp["br"], inp["bi"]) * inp["w"].double()
    fa = inp["fa"][:PREFIX].cpu().numpy()
    fb = inp["fb"][:PREFIX].cpu().numpy()
    return {
        "four_step": X,
        "plan": X,
        "filter_plan": np.convolve(fa.astype(np.float64), inp["h"].astype(np.float64))[:PREFIX]
        + 1j * np.convolve(fb.astype(np.float64), inp["h"].astype(np.float64))[:PREFIX],
        "fft2": torch.fft.fft2(c(inp["ar"], inp["ai"])),
        "tp": torch.fft.ifft(X * c(inp["hr"], inp["hi"])),
        "pp": torch.fft.ifft(torch.fft.fft(blocks) * c(inp["pr"], inp["pi"])),
        "welch": psd,
        "stft": torch.fft.fft(frames * hw)[:, :size // 2 + 1],
    }


def dist_check(out: dict, inp: dict, oracle: dict, tag: str) -> None:
    """The gates of every sharded output against its float64 oracle
    (c2c >= 120 dB, 2-D, PP, TP, Welch, STFT >= 110, FIR >= 100 on the
    128K prefix and around every shard boundary), and the chunked and
    block forms equal to the plain call, bit for bit."""
    import numpy as np
    import torch

    def gate(what, value, limit):
        print(f"{tag} {what}: {value:.1f} dB (gate {limit:.0f})")
        require(value >= limit, f"{tag} {what}: {value:.1f} dB < {limit}")

    fs = out["four_step"]
    gate("four_step 1 x 2^24 vs float64", snr(fs, oracle["four_step"]), DIST_C2C_DB)
    require(all(torch.equal(a, b) for a, b in zip(out["four_step_chunks"], fs)),
            f"{tag} chunks={DIST_CHUNKS} differs from chunks=1")
    require(all(torch.equal(a.reshape(-1), b) for a, b in zip(out["four_step_block"], fs)),
            f"{tag} flatten=False, gathered, differs from flatten=True")
    print(f"{tag} four_step chunks={DIST_CHUNKS} and flatten=False equal chunks=1 bit for bit")
    gate("four_step inverse round trip", snr(out["four_step_inverse"], (inp["xr"], inp["xi"])),
         DIST_C2C_DB)
    gate("plan_dft_1d_sharded 2^24 vs float64", snr(out["plan"], oracle["plan"]), DIST_C2C_DB)
    yr, yi = out["filter_plan"]
    got = yr[:PREFIX].cpu().numpy() + 1j * yi[:PREFIX].cpu().numpy()
    gate(f"FilterPlan(mesh=) vs np.convolve on {PREFIX}", snr(got, oracle["filter_plan"]),
         DIST_FIR_DB)
    gate("fft2_sharded_split 2048^2 vs float64", snr(out["fft2"], oracle["fft2"]),
         DIST_SPECTRUM_DB)
    gate("fft2_mesh2d_split 2048^2 vs float64", snr(out["fft2_mesh2d"], oracle["fft2"]),
         DIST_SPECTRUM_DB)
    gate("tp_spectral_filter_split 2^24 vs float64", snr(out["tp"], oracle["tp"]),
         DIST_SPECTRUM_DB)
    gate("pp_spectral_pipeline_split 64 x 16384 vs float64", snr(out["pp"], oracle["pp"]),
         DIST_SPECTRUM_DB)
    gate("welch_psd_sharded 2^22 at 256 vs float64", snr(out["welch"], oracle["welch"]),
         DIST_SPECTRUM_DB)
    gate("stft_sharded 2^22 at 2048/512 vs float64", snr(out["stft"], oracle["stft"]),
         DIST_SPECTRUM_DB)
    bank = out["filterbank"].cpu().numpy()
    x = inp["bank"].cpu().numpy()
    worst = min(snr(bank[c, :PREFIX], fir_window(x[c], inp["bank_h"][c], 0, PREFIX))
                for c in range(bank.shape[0]))
    gate(f"filterbank {DIST_BANK[0]} x 2^20 vs np.convolve on {PREFIX}", worst, DIST_FIR_DB)


def dist_seams(out: dict, inp: dict, p: int, tag: str) -> None:
    """The overlap-save outputs +-DIST_SEAM samples around every boundary
    of p > 1 shards (the filterbank's 2 of time) against float64
    np.convolve."""
    import numpy as np

    h = inp["h"]
    fa, fb = inp["fa"].cpu().numpy(), inp["fb"].cpu().numpy()
    yr, yi = (t.cpu().numpy() for t in out["filter_plan"])
    x, bank = inp["bank"].cpu().numpy(), out["filterbank"].cpu().numpy()
    worst = []
    for k in range(1, p):
        b = k * SERVING_N // p
        lo, hi = b - DIST_SEAM, b + DIST_SEAM
        want = fir_window(fa, h, lo, hi) + 1j * fir_window(fb, h, lo, hi)
        worst.append(snr(yr[lo:hi] + 1j * yi[lo:hi], want))
    b = DIST_BANK[1] // 2  # the filterbank's time axis: 2 shards
    for c in range(DIST_BANK[0]):
        worst.append(snr(bank[c, b - DIST_SEAM:b + DIST_SEAM],
                         fir_window(x[c], inp["bank_h"][c], b - DIST_SEAM, b + DIST_SEAM)))
    value = min(worst)
    print(f"{tag} overlap-save seams, +-{DIST_SEAM} samples around {len(worst)} shard "
          f"boundaries, vs float64 np.convolve: {value:.1f} dB (gate {DIST_FIR_DB:.0f})")
    require(value >= DIST_FIR_DB, f"{tag} seams {value:.1f} dB")


def _dist_rank(rank: int, world: int, tmp: str, seed: int, device_type: str) -> None:
    """One of the gloo ranks of phase 4h (b), sharing the card: the calls
    of (a) on the same inputs, its launches, the shapes they got and its
    host-clock times written to tmp/rank<r>.json; rank 0 holds every output against (a)'s and the
    oracles, and prints the verdicts and the bytes gloo moved through the
    host."""
    import statistics as stats

    import torch
    import torch.distributed as dist

    from fftlab_torch.dist import comm, four_step_fft_sharded_split
    from fftlab_torch.dist.mesh import mesh_device
    from fftlab_torch.dist.multihost import ensure_initialized
    from fftlab_torch.plan.filter_plan import FilterPlan

    ensure_initialized(f"file://{tmp}/init", world, rank, backend="gloo",
                       device_type=device_type, timeout_s=DIST_TIMEOUT_S)
    meshes = dist_meshes(world, "gloo", device_type)
    dev = mesh_device(meshes["tp"])
    inp = dist_inputs(dev, seed)
    comm.STAGED["bytes"] = 0
    t0 = time.perf_counter()
    out, launches, shapes = dist_calls(inp, meshes)
    calls_s = time.perf_counter() - t0
    staged = comm.STAGED["bytes"]
    tp = meshes["tp"]
    plan = FilterPlan(inp["h"], mesh=tp, time_axis="tp")

    def host_ms(fn, reps=3):
        runs = []
        for _ in range(reps):
            dist.barrier()
            sync(dev)
            t = time.perf_counter()
            fn()
            sync(dev)
            dist.barrier()
            runs.append((time.perf_counter() - t) * 1e3)
        return stats.median(runs)

    times = {"four_step": host_ms(lambda: four_step_fft_sharded_split(
                 inp["xr"], inp["xi"], tp, "tp")),
             "four_step_block": host_ms(lambda: four_step_fft_sharded_split(
                 inp["xr"], inp["xi"], tp, "tp", flatten=False)),
             "filter_plan": host_ms(lambda: plan(inp["fa"], inp["fb"]))}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "shapes": shapes, "staged": staged, "times": times,
                   "calls_s": calls_s}, f)
    if rank == 0:
        tag = f"dist (b) {world} gloo ranks"
        dist_check(out, inp, dist_oracles(inp), tag)
        dist_seams(out, inp, world, tag)
        ref = torch.load(os.path.join(tmp, "a.pt"))
        for name, want in ref.items():
            got = out[name]
            value = snr(got, want)
            print(f"{tag} {name} vs world 1 on NCCL: {value:.1f} dB (gate {DIST_SAME_DB:.0f})")
            require(value >= DIST_SAME_DB, f"{tag} {name} vs (a) {value:.1f} dB")
        print(f"{tag}: every gate held; gloo moved {staged} bytes of this rank's CUDA "
              f"tensors through the host")
    dist.barrier()
    dist.destroy_process_group()


def dist_phase(dev, gen, card: str) -> dict:
    """Phase 4h: the sharded paths on the card (see the module docstring).
    Returns the kernel launches of (a), the main path's run, by kernel,
    and the shapes that (a) and every rank of (b) gave `fft_rows` and
    `os_filter` (`kernel_shapes`), each once."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fftlab_torch.dist import four_step_fft_sharded_split
    from fftlab_torch.dsp.spectrum import welch_psd
    from fftlab_torch.dsp.stft import stft
    from fftlab_torch.plan.dispatch import fft_split_auto, spectral_filter_auto
    from fftlab_torch.plan.filter_plan import FilterPlan

    t_phase = time.perf_counter()
    seed = int(gen.initial_seed()) + 12
    with tempfile.TemporaryDirectory() as tmp:
        # (a) world size 1 on NCCL, in this process
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            meshes = dist_meshes(1, backend, dev.type)
            inp = dist_inputs(dev, seed)
            out, launches, shapes = dist_calls(inp, meshes)
            seen = {k: {tuple(v) for v in logged} for k, logged in shapes.items()}
            want = dist_launches_wanted(1, 0)
            for name, got in launches.items():
                print(f"dist (a) {name} launches: {got}")
                require(got == want[name], f"dist (a) {name} launched {got}, want {want[name]}")
            dist_check(out, inp, dist_oracles(inp), f"dist (a) world 1 on {backend}")
            xr, xi = inp["xr"], inp["xi"]
            auto = fft_split_auto(xr[None], xi[None])
            single = stft(inp["s"], *DIST_STFT)  # its ceil framing: the first frames
            for name, value in (("four_step vs fft_split_auto (three passes)",
                                 snr(out["four_step"], [t[0] for t in auto])),
                                ("tp vs spectral_filter_auto", snr(out["tp"], spectral_filter_auto(
                                    xr, xi, inp["hr"], inp["hi"]))),
                                ("pp vs spectral_filter_auto", snr(out["pp"], spectral_filter_auto(
                                    inp["br"] * inp["w"], inp["bi"] * inp["w"], inp["pr"],
                                    inp["pi"]))),
                                ("FilterPlan(mesh=) vs FilterPlan", snr(out["filter_plan"], FilterPlan(
                                    inp["h"], device=dev)(inp["fa"], inp["fb"]))),
                                ("welch vs welch_psd", snr(out["welch"], welch_psd(
                                    inp["s"], window_size=DIST_WELCH)[1])),
                                ("stft vs stft", snr(out["stft"][:len(single)], single))):
                print(f"dist (a) {name}: {value:.1f} dB (gate {DIST_SAME_DB:.0f})")
                require(value >= DIST_SAME_DB, f"dist (a) {name}: {value:.1f} dB")
            del auto, single
            tp = meshes["tp"]
            xc = torch.complex(xr, xi)
            plan_m = FilterPlan(inp["h"], mesh=tp, time_axis="tp")
            plan_1 = FilterPlan(inp["h"], device=dev)
            ms = {"four_step": time_ms(lambda: four_step_fft_sharded_split(xr, xi, tp, "tp")),
                  "four_step_chunks": time_ms(lambda: four_step_fft_sharded_split(
                      xr, xi, tp, "tp", chunks=DIST_CHUNKS)),
                  "four_step_block": time_ms(lambda: four_step_fft_sharded_split(
                      xr, xi, tp, "tp", flatten=False)),
                  "three_pass": time_ms(lambda: fft_split_auto(xr[None], xi[None])),
                  "cufft": time_ms(lambda: torch.fft.fft(xc)),
                  "filter_plan_mesh": time_ms(lambda: plan_m(inp["fa"], inp["fb"])),
                  "filter_plan": time_ms(lambda: plan_1(inp["fa"], inp["fb"]))}
            print(f"time dist (a) 1 x 2^24: four_step_fft_sharded_split {ms['four_step']:.4f} ms "
                  f"(chunks={DIST_CHUNKS} {ms['four_step_chunks']:.4f}, flatten=False "
                  f"{ms['four_step_block']:.4f}); fft_split_auto (three passes) "
                  f"{ms['three_pass']:.4f}; torch.fft.fft {ms['cufft']:.4f} [{card}]")
            print(f"time dist (a) FilterPlan(mesh=) 2^23 x 2 planes, {SERVING_TAPS} taps: "
                  f"{ms['filter_plan_mesh']:.4f} ms; FilterPlan {ms['filter_plan']:.4f} ms "
                  f"[{card}]")
            # where the four-step's time goes: device time by kernel, one call
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                four_step_fft_sharded_split(xr, xi, tp, "tp")
                sync(dev)
            rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
            spent = sum(e.self_device_time_total for e in rows) / 1e3
            print(f"dist (a) four_step 1 x 2^24, one call, device time by kernel (profiler, "
                  f"{spent:.4f} ms in all) [{card}]: "
                  + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.4f} ms"
                              for e in rows[:10]))
            total = {}
            for got in launches.values():
                for k, c in got.items():
                    total[k] = total.get(k, 0) + c
            torch.save({k: (tuple(t.cpu() for t in out[k]) if isinstance(out[k], tuple)
                            else out[k].cpu())
                        for k in ("four_step", "plan", "filter_plan", "fft2", "fft2_mesh2d",
                                  "tp", "pp", "welch", "stft", "filterbank")},
                       os.path.join(tmp, "a.pt"))
            del out, inp
        finally:
            dist.destroy_process_group()
        t_a = time.perf_counter() - t_phase
        print(f"dist (a) world 1 on {backend}: {t_a:.1f} s; launches of its calls {total}")

        # (b) four ranks sharing the card over gloo, spawned, under a deadline
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dist_rank, args=(r, DIST_RANKS, tmp, seed, dev.type))
                 for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        require(not late, f"dist (b): ranks {late} outlasted {DIST_TIMEOUT_S} s, killed")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        require(not bad, f"dist (b): ranks exited {bad}")
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                rep = json.load(f)
            want = dist_launches_wanted(DIST_RANKS, r)
            for name, got in rep["launches"].items():
                require(got == want[name], f"dist (b) rank {r} {name} launched {got}, "
                                           f"want {want[name]}")
            for k, logged in rep["shapes"].items():
                seen[k].update(tuple(v) for v in logged)
            t = rep["times"]
            print(f"dist (b) rank {r}: launches {rep['launches']}; {rep['staged']} bytes through "
                  f"the host (gloo); calls {rep['calls_s']:.1f} s")
            print(f"time dist (b) rank {r} (gloo through the host, {DIST_RANKS} ranks on one "
                  f"card, host clock, median of 3; not a scaling figure): four_step 2^24 "
                  f"{t['four_step']:.1f} ms, flatten=False {t['four_step_block']:.1f} ms, "
                  f"FilterPlan(mesh=) {t['filter_plan']:.1f} ms [{card}]")
    print(f"dist phase: {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s); the shapes "
          f"the kernels got: " + "; ".join(f"{k} {sorted(v)}" for k, v in seen.items()))
    return total, seen


# the public entries (phase 4i): fftlab_torch.kernels' exports and the
# cio entry at the main paths' shapes, the argument-order repairs, the
# module demos, the copy chain and the entry points
ENTRY_ROWS_SHAPE = (256, 16384)
ENTRY_CIO_SHAPE = (16, 1 << 20)
ENTRY_STFT = (1 << 22, 2048, 512)
ENTRY_PIPELINE = ((16, 1 << 20), (64, 128, 128))
ENTRY_GATES_DB = {"c2c": 120.0, "pipeline": 115.0, "stft": 110.0}
DEMO_MODULES = ("bluestein", "dft", "iterative", "mixed_radix", "radix2", "radix4",
                "recursive", "split_radix", "stockham")
PUBLISHED_GBPS = PEAK_BYTES_PER_S / 1e9
QUICK_SHAPE, QUICK_STEPS = (16, 1 << 18), 64  # quick_bandwidth's planes and longest chain
ENTRY_TIMEOUT_S = 180  # the demos' and the gloo ranks' processes, CUDA start-up included


def _dryrun_rank(rank: int, world: int, init: str, device_type: str) -> None:
    """One of phase 4i's gloo ranks sharing the card: `dryrun_multichip(world)`."""
    import torch.distributed as dist

    from fftlab_torch.dist.multihost import ensure_initialized
    from fftlab_torch.entry import dryrun_multichip

    ensure_initialized(init, world, rank, backend="gloo", device_type=device_type,
                       timeout_s=ENTRY_TIMEOUT_S)
    try:
        dryrun_multichip(world, device_type=device_type, backend="gloo")
    finally:
        dist.destroy_process_group()


def entries_phase(dev, gen, card: str, reset_counts, read_counts) -> dict:
    """Phase 4i: the public entries on the card (see the module docstring).
    Returns the kernel launches of (a), the phase's main path. Every gate
    raises SmokeFailure."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fftlab_torch import kernels
    from fftlab_torch.algos.split_stockham import spectral_filter_split_fused
    from fftlab_torch.bench.timing import chain_time, copy_bandwidth, quick_bandwidth
    from fftlab_torch.core.types import FORWARD, INVERSE
    from fftlab_torch.entry import dryrun_multichip, entry
    from fftlab_torch.kernels import fft_vmem, fourstep_vmem, resident_vmem, stage_fused, stft_vmem
    from fftlab_torch.plan.dispatch import fft_split_auto

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    def planes(B, n):
        return (torch.randn(B, n, generator=gen, device=dev),
                torch.randn(B, n, generator=gen, device=dev))

    def oracle(xr, xi, direction=FORWARD, scale=1.0):
        z = torch.complex(xr.double(), xi.double())
        y = torch.fft.fft(z) if direction == FORWARD else torch.fft.ifft(z) * z.shape[-1]
        return (y * scale).real, (y * scale).imag

    def sandwich_oracle(xr, xi, hr, hi):
        y = torch.fft.ifft(torch.fft.fft(torch.complex(xr.double(), xi.double()))
                           * torch.complex(hr.double(), hi.double()))
        return y.real, y.imag

    def hold(name, got, plain, want, gate):
        torch.cuda.synchronize()
        s_plain = snr(got, plain) if plain is not None else None
        s_want = snr(got, want)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        print(f"entries {name}: "
              + (f"vs plain {s_plain:.1f} dB, " if s_plain is not None else "")
              + f"vs float64 {s_want:.1f} dB (gate {gate:.0f}) [{card}]")
        require(finite, f"entries {name}: non-finite output")
        require(s_plain is None or s_plain >= GATE_PLAIN_DB,
                f"entries {name} vs plain {s_plain} dB")
        require(s_want >= gate, f"entries {name} vs float64 {s_want:.1f} dB")

    # (a) the exports of fftlab_torch.kernels and the cio entry, counts
    # set to 0 just before and read just after
    xr, xi = planes(*ENTRY_ROWS_SHAPE)
    hr, hi = (t[0] for t in planes(1, ENTRY_ROWS_SHAPE[1]))
    cr, ci = planes(*ENTRY_CIO_SHAPE)
    sig = torch.randn(ENTRY_STFT[0], generator=gen, device=dev)
    (pb, pn), factors = ENTRY_PIPELINE
    pr, pi = planes(pb, pn)
    reset_counts()
    rows = kernels.pallas_fft_split(xr, xi)
    cio = resident_vmem.fft_split_resident_cio(cr, ci, INVERSE)
    filt = kernels.pallas_spectral_filter(xr, xi, hr, hi)
    spec = kernels.pallas_stft_split(sig, *ENTRY_STFT[1:])
    pipe = kernels.fft_split_pipeline(pr, pi, FORWARD, factors)
    torch.cuda.synchronize()
    launches = {k: c for k, c in read_counts().items() if c}
    want = {"fft_rows": 1, "fourstep_pass1": 1, "fourstep_pass2": 1, "filter_rows": 1,
            "stft_frames": 1, "fused_stage": len(factors) - 1, "stage_leaf": 1}
    print(f"entries path launches: {launches}")
    require(launches == want, f"the entries launched {launches}, want {want}")
    n_cio = ENTRY_CIO_SHAPE[1]
    hold(f"pallas_fft_split {ENTRY_ROWS_SHAPE}", rows,
         fft_vmem.fft_rows_plain(xr, xi, FORWARD, 1.0), oracle(xr, xi), ENTRY_GATES_DB["c2c"])
    hold(f"fft_split_resident_cio {ENTRY_CIO_SHAPE} inverse", cio,
         fourstep_vmem.fourstep_pass2_plain(*fourstep_vmem.fourstep_pass1_plain(cr, ci, INVERSE),
                                            INVERSE, 1.0 / n_cio),
         oracle(cr, ci, INVERSE, 1.0 / n_cio), ENTRY_GATES_DB["c2c"])
    hold(f"pallas_spectral_filter {ENTRY_ROWS_SHAPE}", filt,
         fft_vmem.spectral_filter_rows_plain(xr, xi, hr, hi), sandwich_oracle(xr, xi, hr, hi),
         ENTRY_GATES_DB["c2c"])
    n_sig, fft_size, hop = ENTRY_STFT
    frames = (n_sig - fft_size) // hop + 1
    w = stft_vmem.window_table("hann", fft_size, dev).double()
    framed = torch.fft.rfft(sig.double().unfold(-1, fft_size, hop)[:frames] * w)
    hold(f"pallas_stft_split {n_sig} samples {fft_size}/{hop}", spec,
         stft_vmem.stft_frames_plain(sig, fft_size, hop, w.float(), frames),
         (framed.real, framed.imag), ENTRY_GATES_DB["stft"])
    hold(f"fft_split_pipeline {ENTRY_PIPELINE[0]} {factors}", pipe,
         stage_fused.fft_split_pipeline_plain(pr, pi, FORWARD, factors), oracle(pr, pi),
         ENTRY_GATES_DB["pipeline"])
    del rows, cio, filt, spec, pipe, cr, ci

    # (b) the argument-order repairs: the keyword forms clear the gates,
    # the JAX-order calls raise (F1, F2) or give JAX's result (F3)
    for name, call in (("F1 fft_split_rows(xr, xi, FORWARD, False)",
                        lambda: fft_vmem.fft_split_rows(xr, xi, FORWARD, False)),
                       ("F2 fft_split_pipeline(xr, xi, FORWARD, factors, 8)",
                        lambda: stage_fused.fft_split_pipeline(pr, pi, FORWARD, factors, 8))):
        try:
            call()
        except TypeError as e:
            print(f"entries {name} raises TypeError: {e}")
        else:
            raise SmokeFailure(f"entries {name} did not raise TypeError")
    hold("F1 fft_split_rows(..., scale=0.5)", fft_vmem.fft_split_rows(xr, xi, FORWARD, scale=0.5),
         fft_vmem.fft_rows_plain(xr, xi, FORWARD, 0.5), oracle(xr, xi, FORWARD, 0.5),
         ENTRY_GATES_DB["c2c"])
    hold("F2 fft_split_pipeline(..., scale=2.0)",
         stage_fused.fft_split_pipeline(pr, pi, FORWARD, factors, scale=2.0),
         stage_fused.fft_split_pipeline_plain(pr, pi, FORWARD, factors, scale=2.0),
         oracle(pr, pi, FORWARD, 2.0), ENTRY_GATES_DB["pipeline"])
    fr, fi = xr[:64], xi[:64]
    hold("F3 spectral_filter_split_fused(xr, xi, hr, hi, 128, 'highest') 64 x 16384",
         spectral_filter_split_fused(fr, fi, hr, hi, 128, "highest"), None,
         sandwich_oracle(fr, fi, hr, hi), ENTRY_GATES_DB["c2c"])
    del xr, xi, hr, hi, pr, pi, fr, fi

    # (d) the copy chain beside the published bound; quick_bandwidth's
    # short chain beside its kernels' device time, which says whether the
    # host's launches set its pace; chain_time of the headline FFT beside
    # time_ms of the same call
    full, quick = copy_bandwidth(device=dev), quick_bandwidth(device=dev)
    for name, gbps in (("copy_bandwidth()", full), ("quick_bandwidth()", quick)):
        require(0 < gbps <= 1.05 * PUBLISHED_GBPS,
                f"{name} read {gbps:.1f} GB/s: a timing fault")
    print(f"entries copy_bandwidth(): {full:.1f} GB/s, {full / PUBLISHED_GBPS:.1%} of the "
          f"published {PUBLISHED_GBPS:.0f} GB/s [{card}]")
    qx = torch.ones(QUICK_SHAPE, device=dev)
    qy = torch.ones(QUICK_SHAPE, device=dev)
    kernel_s = 0.0
    if dev.type == "cuda":  # the CPU rehearsal has no device time to read
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(QUICK_STEPS):
                qx, qy = qx + 1.0, qy + 1.0
            torch.cuda.synchronize()
        kernel_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    kernel_gbps = (16.0 * QUICK_SHAPE[0] * QUICK_SHAPE[1] * QUICK_STEPS / kernel_s / 1e9
                   if kernel_s > 0 else None)
    print(f"entries quick_bandwidth(): {quick:.1f} GB/s on CUDA events (the timing-fault "
          f"gate); its chain of {QUICK_STEPS} steps at {QUICK_SHAPE}, kernels alone (profiler "
          f"device time): " + (f"{kernel_gbps:.1f} GB/s, so the events read "
                               f"{1 - quick / kernel_gbps:.1%} launch gaps"
                               if kernel_gbps else "not measured") + f" [{card}]")
    del qx, qy
    B, n = MAIN_SHAPE
    ar, ai = planes(B, n)
    per_step = chain_time(lambda a, b: fft_split_auto(a, b), lambda r: planes(B, n),
                          ks=(2, 10), repeats=5)
    as_called = time_ms(lambda: fft_split_auto(ar, ai))
    print(f"entries fft_split_auto {MAIN_SHAPE}: chain_time {per_step * 1e3:.4f} ms a step; "
          f"time_ms {as_called:.4f} ms a call [{card}]")
    require(per_step > 0, f"chain_time of fft_split_auto read {per_step} s")
    del ar, ai

    # (c) and the minimal example of (e): subprocesses on the card, started
    # after the timed steps above and read at the end, so their CUDA
    # start-up overlaps (e) (their own microseconds run side by side)
    procs = {f"algos.{m}": subprocess.Popen(
        [sys.executable, "-m", f"fftlab_torch.algos.{m}", "--device", dev.type], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for m in DEMO_MODULES}
    procs["examples.minimal"] = subprocess.Popen(
        [sys.executable, "-m", "fftlab_torch.examples.minimal"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # (e) the entry points: entry() on the card, dryrun_multichip at world
    # 1 on NCCL in this process and in four gloo ranks sharing the card
    fn, fargs = entry(dev)
    require(all(t.device == dev for t in fargs), "entry() placed its inputs off the card")
    out = fn(*fargs)
    hold("entry() 8 x 16384", out, None, sandwich_oracle(*fargs), ENTRY_GATES_DB["c2c"])
    rx = planes(*fargs[0].shape)
    rh = tuple(t[0] for t in planes(1, fargs[2].shape[-1]))
    hold("entry() fn on random planes and H", fn(*rx, *rh), None, sandwich_oracle(*rx, *rh),
         ENTRY_GATES_DB["c2c"])
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            dryrun_multichip(1, device_type=dev.type)
        finally:
            dist.destroy_process_group()
        print(f"entries dryrun_multichip(1) on {backend}: OK")
        ctx = mp.get_context("spawn")
        ranks = [ctx.Process(target=_dryrun_rank,
                             args=(r, DIST_RANKS, f"file://{os.path.join(tmp, 'init')}",
                                   dev.type))
                 for r in range(DIST_RANKS)]
        for p in ranks:
            p.start()
        deadline = time.monotonic() + ENTRY_TIMEOUT_S
        for p in ranks:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(ranks) if p.is_alive()]
        for p in ranks:
            if p.is_alive():
                p.kill()
            p.join()
        require(not late, f"entries dryrun: ranks {late} outlasted {ENTRY_TIMEOUT_S} s, killed")
        bad = [(r, p.exitcode) for r, p in enumerate(ranks) if p.exitcode]
        require(not bad, f"entries dryrun: gloo ranks exited {bad}")
        print(f"entries dryrun_multichip({DIST_RANKS}) in {DIST_RANKS} gloo ranks on the card: OK")

    # (c) the nine module demos and the minimal example, started above
    deadline = time.monotonic() + ENTRY_TIMEOUT_S
    failed = []
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            raise SmokeFailure(f"entries: python -m fftlab_torch.{name} outlasted "
                               f"{ENTRY_TIMEOUT_S} s, killed")
        lines = text.strip().splitlines()
        results = [ln.strip() for ln in lines if "roundtrip" in ln]
        print(f"entries python -m fftlab_torch.{name}: exit "
              f"{proc.returncode}; " + ("; ".join(results) or lines[-1] if lines else "no output")
              + f" [{card}]")
        ok = proc.returncode == 0 and (
            "self-test passed" in text if name == "examples.minimal"
            else len(results) == 3 and all("PASS" in ln for ln in results))
        if not ok:
            failed.append(name)
            print(text)
    require(not failed, f"entries: the demos {failed} failed")
    print(f"entries phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    import numpy as np

    from fftlab_torch import (INVERSE, FilterParams, FilterPlan, FilterType,
                              coherence_split, fft_filter_split, fft_split_auto,
                              istft_split, plan_c2r_1d_split, plan_dft_1d_split,
                              plan_from_jax, plan_r2c_1d_split, spectral_filter_auto,
                              stft_split, welch_psd_split)
    from fftlab_torch.algos.split_stockham import fft_split
    from fftlab_torch.core.types import FORWARD, Direction
    from fftlab_torch.dsp.filtering import design_response
    from fftlab_torch.kernels import (_build, fft_vmem, fourstep_vmem, os_filter_vmem,
                                      rfft_resident, rfft_vmem, stage_fused, stft_vmem,
                                      threestep_vmem)
    from fftlab_torch.plan.dispatch import (run_route, select_filter_impl,
                                            select_split_impl)

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
    ptxas = _build.ptxas_report()
    for k in ptxas:
        print(f"ptxas {k['kernel']}: {k['registers']} registers, {k['spill_stores']} bytes "
              f"spill stores, {k['spill_loads']} bytes spill loads")
    # every instantiation of the register engine: a kernel per length
    engine = ({f"fft_rows_kernel<{e}>" for e in range(9, 15)}
              | {f"fourstep_pass1_kernel<{m}, {e}>" for m in range(3) for e in range(7, 11)}
              | {f"fourstep_pass2_kernel<{m}, {e}>" for m in range(2) for e in range(7, 12)}
              | {f"fourstep_pass2_sandwich_kernel<{e}>" for e in range(7, 12)}
              | {f"fourstep_pass2_unpack_kernel<{e}>" for e in range(8, 11)}
              | {f"fourstep_pass1_kernel<3, {e}>" for e in range(1, 8)}  # the stages
              | {f"fourstep_pass1_kernel<4, {e}>" for e in range(7, 11)}  # no twiddle
              | {f"fourstep_pass2_kernel<2, {e}>" for e in range(7, 12)}  # the leaves
              | {f"{k}_kernel<{e}>" for k in ("filter_rows", "os_filter") for e in range(9, 15)})
    missing = engine - {k["kernel"] for k in ptxas}
    require(not missing, f"ptxas reported no {sorted(missing)}")
    require(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in ptxas),
            "a kernel spills registers")

    # phase 3: every kernel against its plain version and the oracle
    def snr_db(got, want) -> float:
        gr, gi = (g.double() for g in got)
        wr, wi = (w.to(gr.device, torch.float64) for w in want)
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

    def sandwich_oracle(xr, xi, hr, hi):
        z = torch.complex(xr.double(), xi.double())
        y = torch.fft.ifft(torch.fft.fft(z) * torch.complex(hr.double(), hi.double()))
        return y.real, y.imag

    err.update({"filter_rows": 0.0, "fourstep_pass2_sandwich": 0.0, "os_filter": 0.0})
    for B, n in FILTER_ROWS_SHAPES:
        xr, xi = planes(B, n)
        hr, hi = planes(1, n)
        hr, hi = hr[0], hi[0]
        got = fft_vmem.filter_rows(xr, xi, hr, hi)
        plain = fft_vmem.spectral_filter_rows_plain(xr, xi, hr, hi)
        torch.cuda.synchronize()
        s_plain = snr_db(got, plain)
        s_oracle = snr_db(got, sandwich_oracle(xr, xi, hr, hi))
        err["filter_rows"] = max(err["filter_rows"], max_abs(got, plain))
        print(f"check filter_rows B={B} n={n}: vs plain {s_plain:.1f} dB, "
              f"vs oracle {s_oracle:.1f} dB")
        require(s_plain >= GATE_PLAIN_DB, f"filter_rows vs plain {s_plain:.1f} dB")
        require(s_oracle >= GATE_ORACLE_DB["rows"],
                f"filter_rows vs oracle {s_oracle:.1f} dB")
    for B, n in TWO_PASS_SHAPES:
        xr, xi = planes(B, n)
        hr, hi = planes(1, n)
        hr, hi = hr[0], hi[0]
        mid = fourstep_vmem.fourstep_pass1(xr, xi, FORWARD)
        plain2 = fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, hr, hi)
        got2 = fourstep_vmem.fourstep_pass2_sandwich(*mid, hr, hi)  # in place over mid
        got = fourstep_vmem.spectral_filter_large(xr, xi, hr, hi)
        plain = fourstep_vmem.spectral_filter_large_plain(xr, xi, hr, hi)
        torch.cuda.synchronize()
        s2 = snr_db(got2, plain2)
        s_plain = snr_db(got, plain)
        s_oracle = snr_db(got, sandwich_oracle(xr, xi, hr, hi))
        err["fourstep_pass2_sandwich"] = max(err["fourstep_pass2_sandwich"],
                                             max_abs(got2, plain2))
        print(f"check sandwich B={B} n={n}: pass2_sandwich vs plain {s2:.1f} dB, "
              f"whole vs plain {s_plain:.1f} dB, vs oracle {s_oracle:.1f} dB")
        require(s2 >= GATE_PLAIN_DB, f"fourstep_pass2_sandwich vs plain {s2:.1f} dB")
        require(s_plain >= GATE_PLAIN_DB, f"sandwich vs plain {s_plain:.1f} dB")
        require(s_oracle >= GATE_ORACLE_DB["two_pass"],
                f"sandwich vs oracle {s_oracle:.1f} dB at B={B} n={n}")

    def conv_oracle(x, h, m):
        """np.convolve in float64 of the first m samples of every row."""
        xs = x[..., :m].double().cpu().numpy().reshape(-1, m)
        want = [np.convolve(row, np.asarray(h, np.float64))[:m] for row in xs]
        return torch.from_numpy(np.stack(want).reshape(*x.shape[:-1], m))

    rng = np.random.default_rng(args.seed)
    C, n = OS_SHAPE
    xr, xi = planes(C, n)
    for nh, fsz in OS_CASES:
        h = rng.standard_normal(nh) / nh
        got = os_filter_vmem.pallas_os_filter_split(xr, xi, h, fft_size=fsz)
        hr, hi = os_filter_vmem._cached_response(
            np.asarray(h, np.float64).tobytes(), fsz, dev)
        plain = os_filter_vmem.os_filter_plain(xr, xi, hr, hi, nh)
        torch.cuda.synchronize()
        s_plain = snr_db(got, plain)
        s_oracle = snr_db(got, (conv_oracle(xr, h, n), conv_oracle(xi, h, n)))
        err["os_filter"] = max(err["os_filter"], max_abs(got, plain))
        print(f"check os_filter C={C} n={n} taps={nh} fft_size={fsz}: "
              f"vs plain {s_plain:.1f} dB, "
              f"vs np.convolve {s_oracle:.1f} dB")
        require(s_plain >= GATE_PLAIN_DB, f"os_filter vs plain {s_plain:.1f} dB")
        require(s_oracle >= GATE_ORACLE_DB["os_filter"],
                f"os_filter vs np.convolve {s_oracle:.1f} dB at {nh} taps")

    # the real-signal kernels
    def reals(B, n):
        return torch.randn(B, n, generator=gen, device=dev)

    def rfft_oracle(x):
        y = torch.fft.rfft(x.double())
        return y.real, y.imag

    def stft_oracle(x, fft_size, hop, n_frames, onesided=True):
        """float64 framed FFT over the zero-extended signal."""
        need = (n_frames - 1) * hop + fft_size
        xp = torch.nn.functional.pad(x.double(), (0, max(need - x.numel(), 0)))
        w = stft_vmem.window_table("hann", fft_size, dev).double()
        frames = xp.unfold(-1, fft_size, hop)[:n_frames] * w
        y = torch.fft.rfft(frames) if onesided else torch.fft.fft(frames)
        return y.real, y.imag

    def real_snr(got, want):
        return snr_db((got, torch.zeros_like(got)), (want, torch.zeros_like(want)))

    def check(name, s, gate):
        require(s >= gate, f"{name} {s:.1f} dB (gate {gate})")

    # the huge-n r2c/c2r shape (pack_real, interleave, herm_unpack,
    # herm_repack at a half size of 2^22), the pipeline's (2^21) and the
    # fused path's (herm_unpack and herm_repack at 2^20); x, pr, pi stay
    # the fused path's signal
    err.update(dict.fromkeys(("pack_real", "interleave", "herm_unpack", "herm_repack"), 0.0))
    for B, n in (HUGE_RFFT_SHAPE, RFFT_PIPE_SHAPE, RFFT_SHAPE):
        m = n // 2
        x = reals(B, n)
        zr, zi = rfft_vmem.pack_real(x)
        pr, pi = (t.contiguous() for t in rfft_vmem.pack_real_plain(x))
        back = rfft_vmem.interleave(zr, zi)
        torch.cuda.synchronize()
        err["pack_real"] = max(err["pack_real"], max_abs((zr, zi), (pr, pi)))
        err["interleave"] = max(err["interleave"], float(
            (back - rfft_vmem.interleave_plain(zr, zi)).abs().max()))
        print(f"check pack_real / interleave {B} x {n}: max abs vs plain "
              f"{err['pack_real']:.3g} / {err['interleave']:.3g}, round trip "
              f"{float((back - x).abs().max()):.3g}")
        require(err["pack_real"] == 0.0 and err["interleave"] == 0.0
                and bool(torch.equal(back, x)), "pack_real/interleave are not copies")
        Zc = torch.fft.fft(torch.complex(pr.double(), pi.double()))
        Zr, Zi = Zc.real.float(), Zc.imag.float()
        got = rfft_vmem.herm_unpack(Zr, Zi, 0.5)
        plain = rfft_vmem.herm_unpack_plain(Zr, Zi, n, 0.5)
        want = [0.5 * t for t in rfft_oracle(x)]
        torch.cuda.synchronize()
        err["herm_unpack"] = max(err["herm_unpack"], max_abs(got, plain))
        s_plain, s_oracle = snr_db(got, plain), snr_db(got, want)
        print(f"check herm_unpack {B} x {m} (scale 0.5): vs plain {s_plain:.1f} dB, "
              f"vs oracle {s_oracle:.1f} dB")
        check("herm_unpack vs plain", s_plain, GATE_PLAIN_DB)
        check("herm_unpack vs oracle", s_oracle, GATE_ORACLE_DB["real"])
        Xr, Xi = (2.0 * t.float() for t in want)
        got = rfft_vmem.herm_repack(Xr, Xi)
        plain = rfft_vmem.herm_repack_plain(Xr, Xi)
        torch.cuda.synchronize()
        err["herm_repack"] = max(err["herm_repack"], max_abs(got, plain))
        s_plain, s_oracle = snr_db(got, plain), snr_db(got, (Zc.real, Zc.imag))
        print(f"check herm_repack {B} x {m + 1}: vs plain {s_plain:.1f} dB, "
              f"vs oracle {s_oracle:.1f} dB")
        check("herm_repack vs plain", s_plain, GATE_PLAIN_DB)
        check("herm_repack vs oracle", s_oracle, GATE_ORACLE_DB["real"])
    err.update({"fourstep_pass1_packed": 0.0, "fourstep_pass2_interleaved": 0.0})
    for d in (FORWARD, INVERSE):
        mid = fourstep_vmem.fourstep_pass1_packed(x, d)
        mid_plain = fourstep_vmem.fourstep_pass1_packed_plain(x, d)
        y = fourstep_vmem.fourstep_pass2_interleaved(*mid, d, 0.5)
        y_plain = fourstep_vmem.fourstep_pass2_interleaved_plain(*mid, d, 0.5)
        zo = oracle(pr, pi, d, 0.5)
        want_y = torch.stack(zo, dim=-1).reshape(B, n)
        torch.cuda.synchronize()
        err["fourstep_pass1_packed"] = max(err["fourstep_pass1_packed"],
                                           max_abs(mid, mid_plain))
        err["fourstep_pass2_interleaved"] = max(err["fourstep_pass2_interleaved"],
                                                float((y - y_plain).abs().max()))
        s1, s2, s_oracle = (snr_db(mid, mid_plain), real_snr(y, y_plain),
                            real_snr(y, want_y))
        print(f"check packed pass 1 / interleaved pass 2 {B} x {n} dir={int(d)}: "
              f"pass1 vs plain {s1:.1f} dB, pass2 vs plain {s2:.1f} dB, "
              f"whole vs oracle {s_oracle:.1f} dB")
        check("fourstep_pass1_packed vs plain", s1, GATE_PLAIN_DB)
        check("fourstep_pass2_interleaved vs plain", s2, GATE_PLAIN_DB)
        check("packed two-pass vs oracle", s_oracle, GATE_ORACLE_DB["real"])
    # pass 2's unpack mode on the packed pass 1 of the fused path's signal
    mid = fourstep_vmem.fourstep_pass1_packed(x)
    got = fourstep_vmem.fourstep_pass2_unpack(*mid, 0.5)
    plain = rfft_resident.fourstep_pass2_unpack_plain(*mid, 0.5)
    want = [0.5 * t for t in rfft_oracle(x)]
    torch.cuda.synchronize()
    err["fourstep_pass2_unpack"] = max_abs(got, plain)
    s_plain, s_oracle = snr_db(got, plain), snr_db(got, want)
    print(f"check fourstep_pass2_unpack {B} x {n // 2} (scale 0.5): vs plain {s_plain:.1f} dB, "
          f"vs oracle {s_oracle:.1f} dB")
    check("fourstep_pass2_unpack vs plain", s_plain, GATE_PLAIN_DB)
    check("fourstep_pass2_unpack vs oracle", s_oracle, GATE_ORACLE_DB["real"])
    sig = reals(1, STFT_N)[0]
    err["stft_frames"] = 0.0
    for fft_size, hop in STFT_CASES:
        n_frames = (STFT_N - fft_size) // hop + 1
        w = stft_vmem.window_table("hann", fft_size, dev)
        for onesided in (True, False):
            got = stft_vmem.stft_frames(sig, fft_size, hop, w, n_frames, onesided)
            plain = stft_vmem.stft_frames_plain(sig, fft_size, hop, w, n_frames, onesided)
            want = stft_oracle(sig, fft_size, hop, n_frames, onesided)
            torch.cuda.synchronize()
            err["stft_frames"] = max(err["stft_frames"], max_abs(got, plain))
            s_plain, s_oracle = snr_db(got, plain), snr_db(got, want)
            print(f"check stft_frames {STFT_N} samples {fft_size}/{hop} "
                  f"{'one' if onesided else 'two'}-sided: vs plain {s_plain:.1f} dB, "
                  f"vs oracle {s_oracle:.1f} dB")
            check("stft_frames vs plain", s_plain, GATE_PLAIN_DB)
            check("stft_frames vs oracle", s_oracle, GATE_ORACLE_DB["real"])

    # the huge-n kernels: each of the three passes at both ends of the
    # three-pass window and at the main shape, against its plain version
    three = ("threestep_pass_a", "threestep_pass_b", "threestep_pass_c")
    err.update(dict.fromkeys(three + ("fused_stage", "stage_leaf"), 0.0))
    for B, n in THREE_PASS_SHAPES:
        xr, xi = planes(B, n)
        for d, user in cases:
            eff = (1.0 / n if d == INVERSE else 1.0) * (user or 1.0)
            a = threestep_vmem.threestep_pass_a(xr, xi, d)
            b = threestep_vmem.threestep_pass_b(*a, d)
            c = threestep_vmem.threestep_pass_c(*b, d, eff)
            plains = (threestep_vmem.threestep_pass_a_plain(xr, xi, d),
                      threestep_vmem.threestep_pass_b_plain(*a, d),
                      threestep_vmem.threestep_pass_c_plain(*b, d, eff))
            whole = threestep_vmem.fft_split_huge_plain(xr, xi, d, eff)
            torch.cuda.synchronize()
            s_pass = [snr_db(got, plain) for got, plain in zip((a, b, c), plains)]
            for name, got, plain in zip(three, (a, b, c), plains):
                err[name] = max(err[name], max_abs(got, plain))
            s_plain = snr_db(c, whole)
            s_oracle = snr_db(c, oracle(xr, xi, d, eff))
            print(f"check three_pass B={B} n=2^{n.bit_length() - 1} dir={int(d)} "
                  f"scale={eff:.6g}: passes vs plain {s_pass[0]:.1f} / {s_pass[1]:.1f} / "
                  f"{s_pass[2]:.1f} dB, whole vs plain {s_plain:.1f} dB, vs oracle "
                  f"{s_oracle:.1f} dB")
            for name, v in zip(three + ("three_pass",), s_pass + [s_plain]):
                check(f"{name} vs plain at B={B} n={n}", v, GATE_PLAIN_DB)
            check(f"three_pass vs oracle at B={B} n={n}", s_oracle,
                  GATE_ORACLE_DB["three_pass"])
        del xr, xi, a, b, c, plains, whole

    def stage_oracle(xr, xi, r, d, twiddle):
        """One radix-r stage (and its twiddle) in complex128 on the card."""
        B, n = xr.shape
        M = n // r
        j = torch.arange(r, device=dev, dtype=torch.int64)
        F = torch.exp(2j * torch.pi * int(d) * ((j[:, None] * j) % r).double() / r)
        y = torch.einsum("kj,bjm->bkm", F, torch.complex(xr.double(), xi.double())
                         .reshape(B, r, M))
        if twiddle:
            m = torch.arange(M, device=dev, dtype=torch.int64)
            y = y * torch.exp(2j * torch.pi * int(d) * ((j[:, None] * m) % n).double() / n)
        return y.real.reshape(B, n), y.imag.reshape(B, n)

    for B, r, M in STAGE_SHAPES:
        xr, xi = planes(B, r * M)
        for d in (FORWARD, INVERSE):
            for twiddle in (True, False):
                got = stage_fused.fused_stage(xr, xi, r, d, twiddle)
                plain = stage_fused.fused_stage_plain(xr, xi, r, d, twiddle)
                torch.cuda.synchronize()
                err["fused_stage"] = max(err["fused_stage"], max_abs(got, plain))
                s_plain = snr_db(got, plain)
                s_oracle = snr_db(got, stage_oracle(xr, xi, r, d, twiddle))
                print(f"check fused_stage B={B} r={r} M={M} dir={int(d)} "
                      f"twiddle={twiddle}: vs plain {s_plain:.1f} dB, vs oracle "
                      f"{s_oracle:.1f} dB")
                check(f"fused_stage vs plain at r={r} M={M}", s_plain, GATE_PLAIN_DB)
                check(f"fused_stage vs oracle at r={r} M={M}", s_oracle,
                      GATE_ORACLE_DB["stage"])
    for rows, r, M, f1 in SWAP_SHAPES:
        xr, xi = planes(rows, r * M)
        for d in (FORWARD, INVERSE):
            got = stage_fused.swap_stage(xr, xi, r, f1, d)
            plain = stage_fused.swap_stage_plain(xr, xi, r, f1, d)
            torch.cuda.synchronize()
            err["fused_stage"] = max(err["fused_stage"], max_abs(got, plain))
            s_plain = snr_db(got, plain)
            print(f"check swap_stage rows={rows} r={r} M={M} F1={f1} dir={int(d)}: vs plain "
                  f"{s_plain:.1f} dB")
            check(f"swap_stage vs plain at r={r} M={M} F1={f1}", s_plain, GATE_PLAIN_DB)
    for B, n, leaf in LEAF_SHAPES:
        xr, xi = planes(B, n)
        for d, user in cases:
            eff = (1.0 / n if d == INVERSE else 1.0) * (user or 1.0)
            got = stage_fused.stage_leaf(xr, xi, leaf, d, eff)
            plain = stage_fused.stage_leaf_plain(xr, xi, leaf, d, eff)
            torch.cuda.synchronize()
            err["stage_leaf"] = max(err["stage_leaf"], max_abs(got, plain))
            s_plain = snr_db(got, plain)
            print(f"check stage_leaf B={B} n={n} leaf={leaf} dir={int(d)} scale={eff:.6g}: "
                  f"vs plain {s_plain:.1f} dB")
            check(f"stage_leaf vs plain at n={n}", s_plain, GATE_PLAIN_DB)

    # phase 4a: the FFT main path, through the public entry points
    reset_counts()
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
    fft_launches = read_counts()
    print(f"FFT main path launches: {fft_launches}")
    require(fwd.algorithm == "two_pass" and inv.algorithm == "two_pass",
            f"2^20 routes {fwd.algorithm}, {inv.algorithm}")
    require(select_split_impl(n2, B2) == "smem_rows",
            f"16384 route {select_split_impl(n2, B2)}")
    for name in ("fft_rows", "fourstep_pass1", "fourstep_pass2"):
        require(fft_launches[name] > 0,
                f"kernel {name} was not launched on the FFT main path")
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

    def two_pass_plain(ar, ai, d, scale):
        mid = fourstep_vmem.fourstep_pass1_plain(ar, ai, d)
        return fourstep_vmem.fourstep_pass2_plain(*mid, d, scale)

    def hold_plain(what, got, plain):
        """A main-path output against the plain versions of its kernels on
        the same inputs, over every sample."""
        s = snr_db(got, plain)
        print(f"main path {what} vs plain {s:.1f} dB")
        require(s >= GATE_PLAIN_DB, f"main path {what} vs plain {s:.1f} dB")

    hold_plain("16 x 2^20 forward", (yr, yi), two_pass_plain(xr, xi, FORWARD, 1.0))
    hold_plain("16 x 2^20 inverse", (br, bi),
               two_pass_plain(yr, yi, INVERSE, 1.0 / n))
    hold_plain("256 x 16384 fft_split_auto", (vr, vi), fft_vmem.fft_rows_plain(ur, ui))

    # phase 4b: the filter path, through the public entry points
    reset_counts()
    B, n = FILTER_MAIN_SHAPE
    xr, xi = planes(B, n)
    h_real = torch.randn(n, generator=gen, device=dev)
    h_zero = torch.zeros_like(h_real)
    fr, fi = spectral_filter_auto(xr, xi, h_real, h_zero)
    torch.cuda.synchronize()
    sandwich = {k: v for k, v in read_counts().items() if v}
    print(f"filter path sandwich {B} x 2^{n.bit_length() - 1} launches: {sandwich}")
    require(sandwich == SANDWICH_LAUNCHES, f"the sandwich launched {sandwich}")
    B3, n3 = FILTER_ROWS_MAIN_SHAPE
    ur, ui = planes(B3, n3)
    lowpass = FilterParams(FilterType.LOWPASS, 0.1, transition_width=0.02)
    lr, li = fft_filter_split(ur, ui, lowpass)
    torch.cuda.synchronize()
    before = read_counts()
    B4, n4 = BLUESTEIN_SHAPE
    pr, pi = planes(B4, n4)
    qr, qi = fft_split_auto(pr, pi)
    rr, ri = fft_split_auto(qr, qi, INVERSE)
    torch.cuda.synchronize()
    bluestein = {k: v - before[k] for k, v in read_counts().items()}
    B5, n5 = BLUESTEIN_ROWS_SHAPE
    br5, bi5 = planes(B5, n5)
    before = read_counts()
    cr5, ci5 = fft_split_auto(br5, bi5)
    torch.cuda.synchronize()
    bluestein_rows = {k: v - before[k] for k, v in read_counts().items()}
    h_taps = rng.standard_normal(SERVING_TAPS) / SERVING_TAPS
    plan = FilterPlan(h_taps, device=dev)
    sr, si = planes(2, SERVING_N)
    sr, si = sr[0], si[0]
    yr, yi = plan(sr, si)
    packed = plan(sr)
    first = sr[: STREAM_CUTS[-1]]
    plan.reset()
    streamed = torch.cat([plan.stream(first[a:b])
                          for a, b in zip(STREAM_CUTS, STREAM_CUTS[1:])])
    whole = plan(first)
    torch.cuda.synchronize()
    filter_launches = read_counts()
    print(f"filter path launches: {filter_launches}; of them Bluestein "
          f"4 x 500009: {bluestein}; Bluestein {B5} x {n5}: {bluestein_rows}")
    require(select_filter_impl(n) == "two_pass", f"2^20 sandwich route "
            f"{select_filter_impl(n)}")
    require(select_filter_impl(n3) == "smem_rows", f"16384 sandwich route "
            f"{select_filter_impl(n3)}")
    require(plan.uses_kernel(), f"FilterPlan route: {plan.describe()}")
    # a sandwich forward and one inverse
    require({k: v for k, v in bluestein.items() if v}
            == {k: 2 * v for k, v in SANDWICH_LAUNCHES.items()},
            f"Bluestein 4 x 500009 launched {bluestein}")
    require(bluestein_rows["filter_rows"] > 0, f"Bluestein {n5} did not launch filter_rows")
    for name in ("filter_rows", "fourstep_pass1", "fourstep_pass2_sandwich", "os_filter"):
        require(filter_launches[name] > 0,
                f"kernel {name} was not launched on the filter path")
    for t, shape in ((fr, (B, n)), (fi, (B, n)), (lr, (B3, n3)), (li, (B3, n3)),
                     (qr, (B4, n4)), (qi, (B4, n4)), (cr5, (B5, n5)), (ci5, (B5, n5)),
                     (yr, (SERVING_N,)),
                     (yi, (SERVING_N,)), (packed, (SERVING_N,)),
                     (streamed, (STREAM_CUTS[-1],))):
        require(tuple(t.shape) == shape and t.dtype == torch.float32,
                f"output {tuple(t.shape)} {t.dtype}, want {shape} float32")
        require(bool(torch.isfinite(t).all()), "non-finite output")
    s_sf = snr_db((fr, fi), sandwich_oracle(xr, xi, h_real, h_zero))
    h_low = torch.from_numpy(design_response(n3, lowpass)).to(dev)
    s_lp = snr_db((lr, li), sandwich_oracle(ur, ui, h_low, torch.zeros_like(h_low)))
    s_bl = snr_db((qr, qi), oracle(pr, pi, FORWARD, 1.0))
    s_bl_rt = snr_db((rr, ri), (pr, pi))
    s_bl_rows = snr_db((cr5, ci5), oracle(br5, bi5, FORWARD, 1.0))
    m = PREFIX
    s_plan = snr_db((yr[:m], yi[:m]), (conv_oracle(sr, h_taps, m),
                                       conv_oracle(si, h_taps, m)))
    s_packed = snr_db((packed[:m], torch.zeros_like(packed[:m])),
                      (conv_oracle(sr, h_taps, m), torch.zeros(m)))
    # the packed path's second half starts at ceil(n/2): check a window there
    half = SERVING_N // 2
    want_half = conv_oracle(sr[half - SERVING_TAPS + 1: half + m], h_taps,
                            m + SERVING_TAPS - 1)[SERVING_TAPS - 1:]
    s_packed_half = snr_db((packed[half: half + m], torch.zeros(m, device=dev)),
                           (want_half, torch.zeros(m)))
    stream_err = float((streamed - whole).abs().max())
    print(f"filter path: sandwich 16 x 2^20 vs oracle {s_sf:.1f} dB; "
          f"fft_filter_split 256 x 16384 vs oracle {s_lp:.1f} dB; Bluestein "
          f"4 x 500009 vs oracle {s_bl:.1f} dB, round trip {s_bl_rt:.1f} dB; Bluestein "
          f"{B5} x {n5} vs oracle {s_bl_rows:.1f} dB; "
          f"{plan.describe()} 2^23 two planes vs np.convolve {s_plan:.1f} dB, "
          f"packed real {s_packed:.1f} dB (second half {s_packed_half:.1f} dB), "
          f"stream vs whole max abs {stream_err:.3g}")
    require(s_sf >= GATE_ORACLE_DB["two_pass"], f"sandwich main path {s_sf:.1f} dB")
    require(s_lp >= GATE_ORACLE_DB["rows"], f"fft_filter_split {s_lp:.1f} dB")
    require(s_bl >= GATE_ORACLE_DB["bluestein"], f"Bluestein {s_bl:.1f} dB")
    require(s_bl_rt >= GATE_ORACLE_DB["bluestein"],
            f"Bluestein round trip {s_bl_rt:.1f} dB")
    require(s_bl_rows >= GATE_ORACLE_DB["bluestein"], f"Bluestein {n5} {s_bl_rows:.1f} dB")
    for what, v in (("FilterPlan", s_plan), ("packed real", s_packed),
                    ("packed real second half", s_packed_half)):
        require(v >= GATE_ORACLE_DB["os_filter"], f"{what} {v:.1f} dB")
    require(stream_err <= 2e-4, f"stream vs whole call: max abs {stream_err:.3g}")

    # the same outputs against the plain versions on the same inputs: the
    # plain sandwiches on the card, and for Bluestein and FilterPlan the
    # same entry points on host copies, where every kernel route runs its
    # plain version
    hold_plain("spectral_filter_auto 16 x 2^20", (fr, fi),
               fourstep_vmem.spectral_filter_large_plain(xr, xi, h_real, h_zero))
    h_low32 = h_low.float()
    hold_plain("fft_filter_split 256 x 16384", (lr, li),
               fft_vmem.spectral_filter_rows_plain(ur, ui, h_low32,
                                                   torch.zeros_like(h_low32)))
    host = lambda *ts: [t.cpu() for t in ts]
    hold_plain("Bluestein 4 x 500009 forward", (qr, qi), fft_split_auto(*host(pr, pi)))
    hold_plain("Bluestein 4 x 500009 inverse", (rr, ri),
               fft_split_auto(*host(qr, qi), INVERSE))
    hold_plain(f"Bluestein {B5} x {n5}", (cr5, ci5), fft_split_auto(*host(br5, bi5)))
    host_plan = FilterPlan(h_taps, device="cpu")
    zeros = torch.zeros(SERVING_N, device=dev)
    hold_plain("FilterPlan 2^23 two planes", (yr, yi), host_plan(*host(sr, si)))
    hold_plain("FilterPlan 2^23 packed real", (packed, zeros),
               (host_plan(sr.cpu()), zeros))
    first_host = first.cpu()
    host_plan.reset()
    host_streamed = torch.cat([host_plan.stream(first_host[a:b])
                               for a, b in zip(STREAM_CUTS, STREAM_CUTS[1:])])
    hold_plain("FilterPlan stream", (streamed, zeros[: STREAM_CUTS[-1]]),
               (host_streamed, zeros[: STREAM_CUTS[-1]]))

    # phase 4c: the real-signal path, through the public entry points
    reset_counts()
    B, n = RFFT_SHAPE
    x = reals(B, n)
    r2c, c2r = plan_r2c_1d_split(n, batch=B), plan_c2r_1d_split(n, batch=B)
    Xr, Xi = r2c.execute(x)
    y = c2r.execute((Xr, Xi))
    B2, n2 = RFFT_PIPE_SHAPE
    x2 = reals(B2, n2)
    r2c2, c2r2 = plan_r2c_1d_split(n2, batch=B2), plan_c2r_1d_split(n2, batch=B2)
    X2r, X2i = r2c2.execute(x2)
    y2 = c2r2.execute((X2r, X2i))
    sig, sig2 = reals(2, STFT_N)
    spectra = {case: stft_split(sig, *case) for case in STFT_CASES}
    fft_size, hop = STFT_CASES[0]
    back_sig = istft_split(*spectra[STFT_CASES[0]], fft_size, hop, length=STFT_N)
    freqs, psd = welch_psd_split(sig)
    _, coh = coherence_split(sig, 0.6 * sig + 0.4 * sig2)
    torch.cuda.synchronize()
    real_launches = read_counts()
    print(f"real-signal path launches: {real_launches}")
    require(r2c.algorithm == "rfft_resident" and c2r.algorithm == "irfft_resident",
            f"2^21 real routes {r2c.algorithm}, {c2r.algorithm}")
    require(r2c2.algorithm == "rfft_split[two_pass]"
            and c2r2.algorithm == "irfft_split[two_pass]",
            f"2^22 real routes {r2c2.algorithm}, {c2r2.algorithm}")
    for name in ("fourstep_pass1_packed", "fourstep_pass2_interleaved", "fourstep_pass1",
                 "fourstep_pass2", "fourstep_pass2_unpack", "pack_real", "interleave", "herm_unpack",
                 "herm_repack", "stft_frames"):
        require(real_launches[name] > 0,
                f"kernel {name} was not launched on the real-signal path")
    outputs = [(Xr, (B, n // 2 + 1)), (Xi, (B, n // 2 + 1)), (y, (B, n)),
               (X2r, (B2, n2 // 2 + 1)), (X2i, (B2, n2 // 2 + 1)), (y2, (B2, n2)),
               (back_sig, (STFT_N,)),
               (psd, (WELCH,)), (coh, (WELCH,))]
    for (fft_size, hop), (sr, si) in spectra.items():
        frames = -(-(STFT_N - fft_size) // hop) + 1
        outputs += [(sr, (frames, fft_size // 2 + 1)), (si, (frames, fft_size // 2 + 1))]
    for t, shape in outputs:
        require(tuple(t.shape) == shape and t.dtype == torch.float32,
                f"output {tuple(t.shape)} {t.dtype}, want {shape} float32")
        require(bool(torch.isfinite(t).all()), "non-finite output")
    s_r2c = snr_db((Xr, Xi), rfft_oracle(x))
    s_rt = real_snr(y, x)
    s_r2c2 = snr_db((X2r, X2i), rfft_oracle(x2))
    s_rt2 = real_snr(y2, x2)
    s_stft = {}
    for (fft_size, hop), S in spectra.items():
        frames = int(S[0].shape[0])
        s_stft[fft_size, hop] = snr_db(S, stft_oracle(sig, fft_size, hop, frames))
    edge = STFT_CASES[0][0]  # the window energy is about 0 in the first and last frame
    s_istft = real_snr(back_sig[edge:-edge], sig[edge:-edge])
    # float64 Welch and coherence from the oracle's segments
    seg = stft_oracle(sig, 256, 128, (STFT_N - 256) // 128 + 1)
    seg2 = stft_oracle(0.6 * sig + 0.4 * sig2, 256, 128, (STFT_N - 256) // 128 + 1)
    wsq = float((stft_vmem.window_table("hann", 256, dev).double() ** 2).mean())
    dbl = torch.full((WELCH,), 2.0, dtype=torch.float64, device=dev)
    dbl[0] = dbl[-1] = 1.0
    psd_want = (seg[0] ** 2 + seg[1] ** 2).mean(0) / (256 * wsq) * dbl
    sxy_r = (seg[0] * seg2[0] + seg[1] * seg2[1]).mean(0)
    sxy_i = (seg[0] * seg2[1] - seg[1] * seg2[0]).mean(0)
    coh_want = (sxy_r ** 2 + sxy_i ** 2) / (
        (seg[0] ** 2 + seg[1] ** 2).mean(0) * (seg2[0] ** 2 + seg2[1] ** 2).mean(0))
    s_welch, s_coh = real_snr(psd, psd_want), real_snr(coh, coh_want)
    print(f"real-signal path: r2c 8 x 2^21 vs oracle {s_r2c:.1f} dB, c2r round trip "
          f"{s_rt:.1f} dB; r2c 4 x 2^22 {s_r2c2:.1f} dB, round trip {s_rt2:.1f} dB; "
          f"stft {', '.join(f'{a}/{b} {v:.1f}' for (a, b), v in s_stft.items())} dB; "
          f"istft {s_istft:.1f} dB; Welch {s_welch:.1f} dB; coherence {s_coh:.1f} dB")
    for what, v in (("r2c 2^21", s_r2c), ("c2r round trip 2^21", s_rt),
                    ("r2c 2^22", s_r2c2), ("c2r round trip 2^22", s_rt2),
                    *((f"stft {a}/{b}", v) for (a, b), v in s_stft.items()),
                    ("istft", s_istft), ("Welch", s_welch), ("coherence", s_coh)):
        check(f"real-signal path {what}", v, GATE_ORACLE_DB["real"])

    # the same outputs against the plain versions on the same inputs: the
    # plain kernels on the card, and for istft, Welch and coherence the
    # same entry points on host copies
    hold_plain("r2c 8 x 2^21", (Xr, Xi), rfft_resident.rfft_resident_plain(x))
    hold_plain("c2r 8 x 2^21", (y, torch.zeros_like(y)),
               (rfft_resident.irfft_resident_plain(Xr, Xi), torch.zeros_like(y)))
    zr2, zi2 = rfft_vmem.pack_real_plain(x2)
    hold_plain("r2c 4 x 2^22", (X2r, X2i),
               rfft_vmem.herm_unpack_plain(*two_pass_plain(zr2, zi2, FORWARD, 1.0), n2))
    Z2 = rfft_vmem.herm_repack_plain(X2r, X2i)
    y2_plain = rfft_vmem.interleave_plain(*two_pass_plain(*Z2, INVERSE, 2.0 / n2))
    hold_plain("c2r 4 x 2^22", (y2, torch.zeros_like(y2)), (y2_plain, torch.zeros_like(y2)))
    for (fft_size, hop), S in spectra.items():
        frames = int(S[0].shape[0])
        w = stft_vmem.window_table("hann", fft_size, dev)
        hold_plain(f"stft {fft_size}/{hop}", S,
                   stft_vmem.stft_frames_plain(sig, fft_size, hop, w, frames))
    sig_h, sig2_h = sig.cpu(), (0.6 * sig + 0.4 * sig2).cpu()
    S0 = spectra[STFT_CASES[0]]
    back_h = istft_split(S0[0].cpu(), S0[1].cpu(), *STFT_CASES[0], length=STFT_N)
    hold_plain("istft 2048/512", (back_sig[edge:-edge], torch.zeros_like(back_sig[edge:-edge])),
               (back_h[edge:-edge], torch.zeros(STFT_N - 2 * edge)))
    hold_plain("Welch", (psd, torch.zeros_like(psd)),
               (welch_psd_split(sig_h)[1], torch.zeros(WELCH)))
    hold_plain("coherence", (coh, torch.zeros_like(coh)),
               (coherence_split(sig_h, sig2_h)[1], torch.zeros(WELCH)))

    # phase 4d: the huge-n path, through the public entry points; each
    # call runs with every launch count at 0 and is read just after
    huge_launches = dict.fromkeys(three + ("fused_stage", "stage_leaf"), 0)

    def drive(what, fn, kernels):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{what} launches: { {k: counts[k] for k in kernels} }")
        for k in kernels:
            require(counts[k] > 0, f"kernel {k} was not launched by {what}")
            if k in huge_launches:
                huge_launches[k] += counts[k]
        return out

    def outputs_ok(*pairs):
        for t, shape in pairs:
            require(tuple(t.shape) == shape and t.dtype == torch.float32,
                    f"output {tuple(t.shape)} {t.dtype}, want {shape} float32")
            require(bool(torch.isfinite(t).all()), "non-finite output")

    def hold(what, got, plain, want, gate):
        """A huge-n output against its plain version and its oracle."""
        s_plain, s_oracle = snr_db(got, plain), snr_db(got, want)
        print(f"huge-n path {what}: vs plain {s_plain:.1f} dB, vs oracle {s_oracle:.1f} dB")
        check(f"huge-n path {what} vs plain", s_plain, GATE_PLAIN_DB)
        check(f"huge-n path {what} vs oracle", s_oracle, gate)

    B, n = HUGE_MAIN_SHAPE
    xr, xi = planes(B, n)
    fwd, inv = plan_dft_1d_split(n, batch=B), plan_dft_1d_split(n, INVERSE, batch=B)
    require(fwd.algorithm == "three_pass" and inv.algorithm == "three_pass",
            f"2^24 routes {fwd.algorithm}, {inv.algorithm}")
    yr, yi = drive("plan_dft_1d_split(2^24) forward", lambda: fwd.execute((xr, xi)), three)
    br, bi = drive("plan_dft_1d_split(2^24) inverse", lambda: inv.execute((yr, yi)), three)
    outputs_ok((yr, (B, n)), (yi, (B, n)), (br, (B, n)), (bi, (B, n)))
    gate = GATE_ORACLE_DB["three_pass"]
    hold("1 x 2^24 forward", (yr, yi), threestep_vmem.fft_split_huge_plain(xr, xi),
         oracle(xr, xi, FORWARD, 1.0), gate)
    hold("1 x 2^24 inverse", (br, bi),
         threestep_vmem.fft_split_huge_plain(yr, yi, INVERSE, 1.0 / n), (xr, xi), gate)
    del xr, xi, yr, yi, br, bi
    for B, n in HUGE_AUTO_SHAPES:
        ur, ui = planes(B, n)
        require(select_split_impl(n, B) == "three_pass",
                f"2^{n.bit_length() - 1} route {select_split_impl(n, B)}")
        vr, vi = drive(f"fft_split_auto {B} x 2^{n.bit_length() - 1}",
                       lambda: fft_split_auto(ur, ui), three)
        outputs_ok((vr, (B, n)), (vi, (B, n)))
        hold(f"fft_split_auto {B} x 2^{n.bit_length() - 1}", (vr, vi),
             threestep_vmem.fft_split_huge_plain(ur, ui), oracle(ur, ui, FORWARD, 1.0), gate)
        del ur, ui, vr, vi
    B, n = HUGE_RFFT_SHAPE
    x = reals(B, n)
    r2c, c2r = plan_r2c_1d_split(n, batch=B), plan_c2r_1d_split(n, batch=B)
    require(r2c.algorithm == "rfft_split[three_pass]"
            and c2r.algorithm == "irfft_split[three_pass]",
            f"2^23 real routes {r2c.algorithm}, {c2r.algorithm}")
    Xr, Xi = drive("plan_r2c_1d_split(2^23, batch=4)", lambda: r2c.execute(x),
                   three + ("pack_real", "herm_unpack"))
    y = drive("plan_c2r_1d_split(2^23, batch=4)", lambda: c2r.execute((Xr, Xi)),
              three + ("herm_repack", "interleave"))
    outputs_ok((Xr, (B, n // 2 + 1)), (Xi, (B, n // 2 + 1)), (y, (B, n)))
    zr, zi = rfft_vmem.pack_real_plain(x)
    hold("r2c 4 x 2^23", (Xr, Xi), rfft_vmem.herm_unpack_plain(
        *threestep_vmem.fft_split_huge_plain(zr, zi), n), rfft_oracle(x),
        GATE_ORACLE_DB["real"])
    Z = rfft_vmem.herm_repack_plain(Xr, Xi)
    y_plain = rfft_vmem.interleave_plain(
        *threestep_vmem.fft_split_huge_plain(*Z, INVERSE, 2.0 / n))
    zeros = torch.zeros_like(y)
    hold("c2r 4 x 2^23 round trip", (y, zeros), (y_plain, zeros), (x, zeros),
         GATE_ORACLE_DB["real"])
    del x, Xr, Xi, y, zr, zi, Z, y_plain, zeros
    B, n = PIPELINE_SHAPE
    pipe = plan_from_jax("pallas_pipeline", n)
    require(pipe.algorithm == "stage_pipeline", f"pallas_pipeline maps to {pipe.algorithm}")
    pr, pi = planes(B, n)
    qr, qi = drive("plan_from_jax(pallas_pipeline, 2^20) 16 x 2^20",
                   lambda: pipe.execute((pr, pi)), ("fused_stage", "stage_leaf"))
    B2, n2 = PIPELINE_SMALL_SHAPE
    sr, si = planes(B2, n2)
    tr, ti = drive("run_route(stage_pipeline) 2 x 2^15",
                   lambda: run_route("stage_pipeline", sr, si, FORWARD),
                   ("fused_stage", "stage_leaf"))
    outputs_ok((qr, (B, n)), (qi, (B, n)), (tr, (B2, n2)), (ti, (B2, n2)))
    hold("stage_pipeline 16 x 2^20", (qr, qi), stage_fused.fft_split_pipeline_plain(
        pr, pi, FORWARD, stage_fused.pipeline_factors(n)), oracle(pr, pi, FORWARD, 1.0),
        GATE_ORACLE_DB["stage"])
    hold("stage_pipeline 2 x 2^15", (tr, ti), stage_fused.fft_split_pipeline_plain(
        sr, si, FORWARD, stage_fused.pipeline_factors(n2)), oracle(sr, si, FORWARD, 1.0),
        GATE_ORACLE_DB["stage"])
    print(f"huge-n path launches: {huge_launches}")
    stages = len(stage_fused.pipeline_factors(n)) + len(stage_fused.pipeline_factors(n2)) - 2
    require(huge_launches["fused_stage"] == stages and huge_launches["stage_leaf"] == 2,
            f"the two pipelines launched {huge_launches['fused_stage']} stages and "
            f"{huge_launches['stage_leaf']} leaves, want {stages} and 2")
    del pr, pi, qr, qi, sr, si, tr, ti

    # phase 4e: the complex API, through the public entry points
    complex_api_phase(dev, gen, card, reset_counts, read_counts)

    # phase 4f: the DSP, through the public entry points
    dsp_cases = dsp_phase(dev, gen, card, reset_counts, read_counts)

    # phase 4g: the single-card edges, through the public entry points
    edges_phase(dev, gen, card, reset_counts, read_counts)

    # phase 4h: the sharded paths, through the public entry points
    dist_launches, dist_shapes = dist_phase(dev, gen, card)

    # phase 4i: the public entries, the repairs, the demos and the entry points
    entry_launches = entries_phase(dev, gen, card, reset_counts, read_counts)

    # every shape the sharded paths gave fft_rows and os_filter, on fresh
    # planes, against the plain versions and float64 (these launches are
    # not the path's)
    for B, n, d, eff in sorted(dist_shapes["fft_rows"]):
        d = Direction(d)
        xr, xi = planes(B, n)
        got = fft_vmem.fft_rows(xr, xi, d, eff)
        plain = fft_vmem.fft_rows_plain(xr, xi, d, eff)
        torch.cuda.synchronize()
        s_plain = snr_db(got, plain)
        s_oracle = snr_db(got, oracle(xr, xi, d, eff))
        err["fft_rows"] = max(err["fft_rows"], max_abs(got, plain))
        print(f"check fft_rows at the sharded paths' B={B} n={n} dir={int(d)} "
              f"scale={eff:.6g}: vs plain {s_plain:.1f} dB, vs oracle {s_oracle:.1f} dB")
        require(s_plain >= GATE_PLAIN_DB, f"fft_rows vs plain {s_plain:.1f} dB at B={B} n={n}")
        require(s_oracle >= GATE_ORACLE_DB["rows"],
                f"fft_rows vs oracle {s_oracle:.1f} dB at B={B} n={n}")
    for C, n, fsz, nh in sorted(dist_shapes["os_filter"]):
        h = rng.standard_normal(nh) / nh
        hr, hi = os_filter_vmem._cached_response(np.asarray(h, np.float64).tobytes(), fsz, dev)
        xr, xi = planes(C, n)
        got = os_filter_vmem.os_filter(xr, xi, hr, hi, nh)
        plain = os_filter_vmem.os_filter_plain(xr, xi, hr, hi, nh)
        torch.cuda.synchronize()
        m = min(n, PREFIX)
        s_plain = snr_db(got, plain)
        s_oracle = snr_db((got[0][:, :m], got[1][:, :m]),
                          (conv_oracle(xr, h, m), conv_oracle(xi, h, m)))
        err["os_filter"] = max(err["os_filter"], max_abs(got, plain))
        print(f"check os_filter at the sharded paths' C={C} n={n} taps={nh} fft_size={fsz}: "
              f"vs plain {s_plain:.1f} dB, vs np.convolve on {m} {s_oracle:.1f} dB")
        require(s_plain >= GATE_PLAIN_DB, f"os_filter vs plain {s_plain:.1f} dB at n={n}")
        require(s_oracle >= GATE_ORACLE_DB["os_filter"],
                f"os_filter vs np.convolve {s_oracle:.1f} dB at n={n}")
    del xr, xi, got, plain

    # phase 5: timing with CUDA events (time_ms)
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
    # the device time alone, of the kernel and of cuFFT: for a kernel this
    # short the calls' time can be the host's (stft_frames below)
    ms["fft_rows_graph"] = time_ms(lambda: fft_vmem.fft_rows(ur, ui), graph=True)
    ms["cufft_16k_graph"] = time_ms(lambda: torch.fft.fft(uc), graph=True)
    print(f"graph {ROWS_MAIN_SHAPE[0]} x {ROWS_MAIN_SHAPE[1]}: fft_rows "
          f"{ms['fft_rows_graph']:.4f} ms, cuFFT {ms['cufft_16k_graph']:.4f} ms; calls "
          f"{ms['fft_rows']:.4f} and {ms['cufft_16k']:.4f} ms [{card}]")
    shapes = {name: ROWS_MAIN_SHAPE for name in ("fft_rows", "fft_rows_graph", "fft_rows_plain",
                                                 "cufft_16k", "cufft_16k_graph")}

    # the two-pass sandwich at each of its shapes beside cuFFT's three
    # calls; the sandwich mode alone (in place) at the main path's, with
    # an all-pass H times L1, so that each call keeps its input's scale
    for B, n in TWO_PASS_SHAPES:
        xr, xi = planes(B, n)
        hr, hi = planes(1, n)
        hr, hi = hr[0], hi[0]
        xc, hc = torch.complex(xr, xi), torch.complex(hr, hi)
        tag = f"_2^{n.bit_length() - 1}"
        ms["sandwich" + tag] = time_ms(
            lambda: fourstep_vmem.spectral_filter_large(xr, xi, hr, hi))
        ms["sandwich_plain" + tag] = time_ms(
            lambda: fourstep_vmem.spectral_filter_large_plain(xr, xi, hr, hi))
        ms["cufft_sandwich" + tag] = time_ms(lambda: torch.fft.ifft(torch.fft.fft(xc) * hc))
        shapes.update(dict.fromkeys(("sandwich" + tag, "sandwich_plain" + tag,
                                     "cufft_sandwich" + tag), (B, n)))
        print(f"sandwich {B} x 2^{n.bit_length() - 1}: three launches "
              f"{ms['sandwich' + tag]:.4f} ms, cuFFT's three calls "
              f"{ms['cufft_sandwich' + tag]:.4f} ms [{card}]")
        if (B, n) != FILTER_MAIN_SHAPE:
            continue
        L1 = fourstep_vmem._split_sides(n)[0]
        phase = 2 * math.pi * torch.rand(n, generator=gen, device=dev)
        ar, ai = L1 * torch.cos(phase), L1 * torch.sin(phase)
        mid = fourstep_vmem.fourstep_pass1(xr, xi, FORWARD)
        ms["fourstep_pass2_sandwich"] = time_ms(
            lambda: fourstep_vmem.fourstep_pass2_sandwich(*mid, ar, ai))
        ms["fourstep_pass2_sandwich_plain"] = time_ms(
            lambda: fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, ar, ai))
        require(bool(torch.isfinite(mid[0]).all() and torch.isfinite(mid[1]).all()),
                "the sandwich mode's timing input left its range")
        shapes.update(dict.fromkeys(("fourstep_pass2_sandwich",
                                     "fourstep_pass2_sandwich_plain"), (B, n)))
    B, n = BLUESTEIN_SHAPE
    xr, xi = planes(B, n)
    xc = torch.complex(xr, xi)
    ms["bluestein"] = time_ms(lambda: fft_split_auto(xr, xi))
    ms["cufft_bluestein"] = time_ms(lambda: torch.fft.fft(xc))
    shapes.update(dict.fromkeys(("bluestein", "cufft_bluestein"), (B, n)))
    print(f"Bluestein {B} x {n}: fft_split_auto {ms['bluestein']:.4f} ms, torch.fft.fft "
          f"{ms['cufft_bluestein']:.4f} ms [{card}]")
    del xr, xi, xc, hc, mid, ar, ai
    B, n = FILTER_ROWS_MAIN_SHAPE
    ur, ui = planes(B, n)
    hr, hi = planes(1, n)
    hr, hi = hr[0], hi[0]
    uc, hc = torch.complex(ur, ui), torch.complex(hr, hi)
    ms["filter_rows"] = time_ms(lambda: fft_vmem.filter_rows(ur, ui, hr, hi))
    ms["filter_rows_plain"] = time_ms(
        lambda: fft_vmem.spectral_filter_rows_plain(ur, ui, hr, hi))
    ms["cufft_sandwich_16k"] = time_ms(
        lambda: torch.fft.ifft(torch.fft.fft(uc) * hc))
    ms["filter_rows_graph"] = time_ms(lambda: fft_vmem.filter_rows(ur, ui, hr, hi), graph=True)
    ms["cufft_sandwich_16k_graph"] = time_ms(
        lambda: torch.fft.ifft(torch.fft.fft(uc) * hc), graph=True)
    shapes.update(dict.fromkeys(("filter_rows", "filter_rows_plain", "filter_rows_graph",
                                 "cufft_sandwich_16k", "cufft_sandwich_16k_graph"),
                                FILTER_ROWS_MAIN_SHAPE))
    # the Bluestein and fft_convolution_split end of the row sandwich
    B5, n5 = FILTER_ROWS_SHAPES[-1]
    wr, wi = planes(B5, n5)
    gr, gi = (g[0] for g in planes(1, n5))
    ms["filter_rows_small"] = time_ms(lambda: fft_vmem.filter_rows(wr, wi, gr, gi))
    ms["filter_rows_small_graph"] = time_ms(lambda: fft_vmem.filter_rows(wr, wi, gr, gi),
                                            graph=True)
    shapes.update(dict.fromkeys(("filter_rows_small", "filter_rows_small_graph"), (B5, n5)))
    print(f"graph filter_rows {B} x {n}: {ms['filter_rows_graph']:.4f} ms, cuFFT's three "
          f"calls {ms['cufft_sandwich_16k_graph']:.4f} ms; calls {ms['filter_rows']:.4f} and "
          f"{ms['cufft_sandwich_16k']:.4f} ms; {B5} x {n5}: graph "
          f"{ms['filter_rows_small_graph']:.4f} ms, calls {ms['filter_rows_small']:.4f} ms "
          f"[{card}]")
    # the serving shape: bench.py bench_serving_filter, one 2^23-sample
    # signal of two planes, 129 taps; in FilterPlan's frame (the main
    # path's launches, 1K) and in bench.py's 16K frames
    sr, si = planes(1, SERVING_N)
    nh = SERVING_TAPS
    h_taps = rng.standard_normal(nh) / nh
    for fsz, tag in ((plan.kernel_fft_size(), ""),
                     (os_filter_vmem.MAX_FFT_SIZE, "_16k")):
        kr, ki = os_filter_vmem._cached_response(
            np.asarray(h_taps, np.float64).tobytes(), fsz, dev)
        hop = fsz - (nh - 1)
        n_blocks = -(-SERVING_N // hop)
        kc = torch.complex(kr, ki)

        def cufft_os():
            z = torch.nn.functional.pad(torch.complex(sr, si),
                                        (nh - 1, n_blocks * hop + fsz - SERVING_N))
            y = torch.fft.ifft(torch.fft.fft(z.unfold(-1, fsz, hop)[:, :n_blocks]) * kc)
            return y[..., nh - 1:].reshape(1, -1)[:, :SERVING_N]

        s_cufft_os = snr_db((cufft_os().real, cufft_os().imag),
                            os_filter_vmem.os_filter(sr, si, kr, ki, nh))
        require(s_cufft_os >= GATE_PLAIN_DB,
                f"os_filter vs its cuFFT comparator {s_cufft_os:.1f} dB at {fsz}")
        names = [f"os_filter{tag}", f"os_filter{tag}_plain", f"cufft_os_blocks{tag}"]
        ms[names[0]] = time_ms(lambda: os_filter_vmem.os_filter(sr, si, kr, ki, nh))
        ms[names[1]] = time_ms(
            lambda: os_filter_vmem.os_filter_plain(sr, si, kr, ki, nh))
        ms[names[2]] = time_ms(cufft_os)
        names.append(f"os_filter{tag}_graph")
        ms[names[3]] = time_ms(lambda: os_filter_vmem.os_filter(sr, si, kr, ki, nh), graph=True)
        shapes.update(dict.fromkeys(names, (1, SERVING_N)))
        print(f"serving shape: fft_size {fsz}, hop {hop}, {n_blocks} frames, T = "
              f"{os_filter_vmem.frames_per_block(fsz)}: os_filter {ms[names[0]]:.4f} ms, graph "
              f"{ms[names[3]]:.4f} ms [{card}]")
    # the library's causal FIR on the same planes: one conv1d call (cuDNN,
    # TF32 off) of the flipped taps over both planes as a batch of two
    sig2 = torch.stack([sr[0], si[0]]).unsqueeze(1)
    w = torch.from_numpy(np.ascontiguousarray(h_taps[::-1])).float().to(dev).view(1, 1, nh)
    conv = lambda: torch.nn.functional.conv1d(sig2, w, padding=nh - 1)
    fir = conv()[:, 0, :SERVING_N]
    kr, ki = os_filter_vmem._cached_response(
        np.asarray(h_taps, np.float64).tobytes(), plan.kernel_fft_size(), dev)
    s_conv = snr_db((fir[0:1], fir[1:2]), os_filter_vmem.os_filter(sr, si, kr, ki, nh))
    require(s_conv >= GATE_ORACLE_DB["os_filter"],
            f"os_filter vs conv1d {s_conv:.1f} dB")
    ms["conv1d_fir"] = time_ms(conv)
    shapes["conv1d_fir"] = (1, SERVING_N)
    print(f"os_filter vs conv1d: {s_conv:.1f} dB")
    # os_filter's frames per block at FilterPlan's frame, each T checked
    # against the plain version, then timed as graphs in turns (a b b a);
    # its launches count apart from the main path's
    fsz = plan.kernel_fft_size()
    want = os_filter_vmem.os_filter_plain(sr, si, kr, ki, nh)
    ab_os = {"os_filter": 0}
    launch_t = lambda T: os_filter_vmem._launch_os(sr, si, kr, ki, nh, T, ab_os)
    for T in OS_AB_FRAMES:
        s_t = snr_db(launch_t(T), want)
        require(s_t >= GATE_PLAIN_DB, f"os_filter T={T} vs plain {s_t:.1f} dB")
    runs = {T: [] for T in OS_AB_FRAMES}
    for T in OS_AB_FRAMES + OS_AB_FRAMES[::-1]:
        runs[T].append(time_ms(lambda: launch_t(T), graph=True))
    for T, rs in runs.items():
        ms[f"ab_os_T{T}"], shapes[f"ab_os_T{T}"] = statistics.mean(rs), (1, SERVING_N)
    print(f"A/B os_filter {fsz} frames T: "
          + ", ".join(f"T={T} {rs} ms" for T, rs in runs.items())
          + f"; default T={os_filter_vmem.frames_per_block(fsz)}, faster "
          f"T={min(runs, key=lambda T: statistics.mean(runs[T]))} [{card}]")
    # the frame-size sweep at the serving shape, each size checked against
    # the plain version first; FilterPlan's choice of frame does not change
    # with it
    for fsz in OS_SWEEP:
        kr, ki = os_filter_vmem._cached_response(
            np.asarray(h_taps, np.float64).tobytes(), fsz, dev)
        s_f = snr_db(os_filter_vmem.os_filter(sr, si, kr, ki, nh),
                     os_filter_vmem.os_filter_plain(sr, si, kr, ki, nh))
        require(s_f >= GATE_PLAIN_DB, f"os_filter {fsz} frames vs plain {s_f:.1f} dB")
        call = lambda: os_filter_vmem.os_filter(sr, si, kr, ki, nh)
        name = f"sweep_os_{fsz}"
        ms[name], ms[name + "_graph"] = time_ms(call), time_ms(call, graph=True)
        shapes[name] = shapes[name + "_graph"] = (1, SERVING_N)
        print(f"sweep os_filter {fsz} frames, {nh} taps, hop {fsz - nh + 1}, T = "
              f"{os_filter_vmem.frames_per_block(fsz)}: {ms[name]:.4f} ms, graph "
              f"{ms[name + '_graph']:.4f} ms ({s_f:.1f} dB vs plain) [{card}]")
    # the real-signal kernels at the main path's shapes
    B, n = RFFT_SHAPE
    x = reals(B, n)
    zr, zi = rfft_vmem.pack_real(x)
    Zr, Zi = fourstep_vmem.fft_split_large(zr, zi)
    Xr, Xi = rfft_vmem.herm_unpack(Zr, Zi)
    mid = fourstep_vmem.fourstep_pass1(Zr, Zi, INVERSE)
    xc = torch.complex(Xr, Xi)
    ms["pack_real"] = time_ms(lambda: rfft_vmem.pack_real(x))
    ms["pack_real_plain"] = time_ms(
        lambda: [t.contiguous() for t in rfft_vmem.pack_real_plain(x)])
    ms["interleave"] = time_ms(lambda: rfft_vmem.interleave(zr, zi))
    ms["interleave_plain"] = time_ms(lambda: rfft_vmem.interleave_plain(zr, zi))
    ms["herm_unpack"] = time_ms(lambda: rfft_vmem.herm_unpack(Zr, Zi))
    ms["herm_unpack_plain"] = time_ms(lambda: rfft_vmem.herm_unpack_plain(Zr, Zi, n))
    ms["herm_repack"] = time_ms(lambda: rfft_vmem.herm_repack(Xr, Xi))
    ms["herm_repack_plain"] = time_ms(lambda: rfft_vmem.herm_repack_plain(Xr, Xi))
    ms["fourstep_pass1_packed"] = time_ms(lambda: fourstep_vmem.fourstep_pass1_packed(x))
    ms["fourstep_pass1_packed_plain"] = time_ms(
        lambda: fourstep_vmem.fourstep_pass1_packed_plain(x))
    ms["fourstep_pass2_interleaved"] = time_ms(
        lambda: fourstep_vmem.fourstep_pass2_interleaved(*mid, INVERSE, 2.0 / n))
    packed = fourstep_vmem.fourstep_pass1_packed(x)
    ms["fourstep_pass2_unpack"] = time_ms(lambda: fourstep_vmem.fourstep_pass2_unpack(*packed))
    ms["fourstep_pass2_unpack_plain"] = time_ms(
        lambda: rfft_resident.fourstep_pass2_unpack_plain(*packed))
    ms["fourstep_pass2_interleaved_plain"] = time_ms(
        lambda: fourstep_vmem.fourstep_pass2_interleaved_plain(*mid, INVERSE, 2.0 / n))
    ms["rfft_fused_plain"] = time_ms(lambda: rfft_resident.rfft_resident_plain(x))
    ms["irfft_fused"] = time_ms(lambda: rfft_resident.irfft_resident(Xr, Xi))
    ms["irfft_fused_plain"] = time_ms(lambda: rfft_resident.irfft_resident_plain(Xr, Xi))
    ms["cufft_rfft"] = time_ms(lambda: torch.fft.rfft(x))
    ms["cufft_irfft"] = time_ms(lambda: torch.fft.irfft(xc, n))
    ms["stack_interleave"] = time_ms(lambda: torch.stack([zr, zi], dim=-1))

    # the A/B of ROADMAP K6: the fused r2c (2 launches) against the
    # pipeline (4 launches), in turns on the same card
    def fused():
        return fourstep_vmem.fourstep_pass2_unpack(*fourstep_vmem.fourstep_pass1_packed(x))

    def pipeline():
        return rfft_vmem.herm_unpack(*fourstep_vmem.fourstep_pass2(
            *fourstep_vmem.fourstep_pass1(*rfft_vmem.pack_real(x))))

    s_ab = snr_db(fused(), pipeline())
    require(s_ab >= GATE_PLAIN_DB, f"fused vs pipeline r2c {s_ab:.1f} dB")
    ab = {"rfft_fused": [], "rfft_pipeline": []}
    for name in ("rfft_fused", "rfft_pipeline", "rfft_pipeline", "rfft_fused"):
        ab[name].append(time_ms(fused if name == "rfft_fused" else pipeline))
    for name, runs in ab.items():
        ms[name] = statistics.mean(runs)
    faster = min(ab, key=lambda k: ms[k])
    print(f"A/B r2c {B} x {n}: fused {ab['rfft_fused']} ms, pipeline "
          f"{ab['rfft_pipeline']} ms (fused vs pipeline {s_ab:.1f} dB): "
          f"{faster} is faster [{card}]")
    shapes.update(dict.fromkeys(
        ("pack_real", "pack_real_plain", "interleave", "interleave_plain", "herm_unpack",
         "herm_unpack_plain", "herm_repack", "herm_repack_plain", "fourstep_pass1_packed",
         "fourstep_pass1_packed_plain", "fourstep_pass2_interleaved",
         "fourstep_pass2_interleaved_plain", "fourstep_pass2_unpack",
         "fourstep_pass2_unpack_plain", "rfft_fused", "rfft_fused_plain",
         "rfft_pipeline", "irfft_fused", "irfft_fused_plain", "cufft_rfft",
         "cufft_irfft", "stack_interleave"), RFFT_SHAPE))
    # the geometry A/B of the two-pass kernels, in turns on the same card:
    # W columns per pass-1 block, R rows per block of pass 2 and of its
    # sandwich mode (checked on a copy of pass 1's output, timed in place
    # with an all-pass H times L1); its launches count apart from the main
    # path's
    ab_counts = dict.fromkeys(fourstep_vmem.LAUNCHES, 0)
    for B, n in AB_SHAPES:
        sides = fourstep_vmem._split_sides(n)
        L1, L2 = sides
        xr, xi = planes(B, n)
        mid = fourstep_vmem.fourstep_pass1(xr, xi)
        want1 = fourstep_vmem.fourstep_pass1_plain(xr, xi)
        want2 = fourstep_vmem.fourstep_pass2_plain(*mid)
        hr, hi = (h[0] for h in planes(1, n))
        want3 = fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, hr, hi)
        phase = 2 * math.pi * torch.rand(n, generator=gen, device=dev)
        ar, ai = L1 * torch.cos(phase), L1 * torch.sin(phase)
        smid = [t.clone() for t in mid]

        def pass1(g):
            return fourstep_vmem._launch_pass1("fourstep_pass1", xr, xi, FORWARD, sides,
                                               ab_counts, geometry=g)

        def pass2(g):
            return fourstep_vmem._launch_pass2("fourstep_pass2", *mid, FORWARD, 1.0,
                                               sides, ab_counts, geometry=g)

        def sandwich(g):
            return fourstep_vmem._launch_sandwich(*(t.clone() for t in mid), hr, hi,
                                                  ab_counts, geometry=g)

        def sandwich_in_place(g):
            return fourstep_vmem._launch_sandwich(*smid, ar, ai, ab_counts, geometry=g)

        rows = (16, 8) if 16 * L2 <= 16384 else (8, 4)
        arms = (("pass1", fourstep_vmem.pass1_geometry(L1, L2).T,
                 {f"W={v}": fourstep_vmem.pass1_geometry(L1, L2, v) for v in (16, 8)},
                 pass1, pass1, want1),
                ("pass2", fourstep_vmem.pass2_geometry(L1, L2).T,
                 {f"R={v}": fourstep_vmem.pass2_geometry(L1, L2, v) for v in rows},
                 pass2, pass2, want2),
                ("sandwich", fourstep_vmem.sandwich_geometry(L1, L2).T,
                 {f"R={v}": fourstep_vmem.sandwich_geometry(L1, L2, v) for v in (4, 8)},
                 sandwich, sandwich_in_place, want3))
        for kernel, default, geos, check, launch, want in arms:
            for label, geo in geos.items():
                s_geo = snr_db(check(geo), want)
                require(s_geo >= GATE_PLAIN_DB, f"{kernel} {label} vs plain {s_geo:.1f} dB")
            runs = {label: [] for label in geos}
            for label in list(geos) + list(geos)[::-1]:  # in turns: a b b a
                runs[label].append(time_ms(lambda: launch(geos[label])))
            for label, rs in runs.items():
                name = f"ab_{kernel}_{label.replace('=', '')}_2^{n.bit_length() - 1}"
                ms[name], shapes[name] = statistics.mean(rs), (B, n)
            faster = min(runs, key=lambda k: statistics.mean(runs[k]))
            print(f"A/B geometry {B} x 2^{n.bit_length() - 1} {kernel}: "
                  + ", ".join(f"{k} {v} ms" for k, v in runs.items())
                  + f"; default {'W' if kernel == 'pass1' else 'R'}={default}, faster "
                  f"{faster} [{card}]")
        require(bool(torch.isfinite(smid[0]).all() and torch.isfinite(smid[1]).all()),
                "the sandwich mode's timing input left its range")
    del xr, xi, mid, want1, want2, want3, smid
    # stft_frames: at 256/128 the wrapper's host time per call is as long
    # as the kernel, so the calls' time is the host's there; the kernel
    # and torch.stft are also timed as CUDA graphs (the device time
    # alone), and so is the A/B of T, frames_per_block's T against the
    # other candidate, in turns a b b a; its launches count apart from
    # the main path's
    sig = reals(1, STFT_N)[0]
    ab_stft = {"stft_frames": 0}
    for fft_size, hop in STFT_CASES:
        n_frames = (STFT_N - fft_size) // hop + 1
        w = stft_vmem.window_table("hann", fft_size, dev)
        tag = f"_{fft_size}_{hop}"
        kernel = lambda: stft_vmem.stft_frames(sig, fft_size, hop, w, n_frames)
        library = lambda: torch.stft(sig, fft_size, hop, window=w, center=False,
                                     return_complex=True)
        ms["stft_frames" + tag] = time_ms(kernel)
        ms["cufft_stft" + tag] = time_ms(library)
        ms["stft_frames_graph" + tag] = time_ms(kernel, graph=True)
        ms["cufft_stft_graph" + tag] = time_ms(library, graph=True)
        print(f"graph stft {fft_size}/{hop}: stft_frames {ms['stft_frames_graph' + tag]:.4f} "
              f"ms, torch.stft {ms['cufft_stft_graph' + tag]:.4f} ms; calls "
              f"{ms['stft_frames' + tag]:.4f} and {ms['cufft_stft' + tag]:.4f} ms [{card}]")
        arms = STFT_AB_FRAMES[fft_size]
        for T in arms:
            for onesided in (True, False):
                s_t = snr_db(stft_vmem._launch_stft(sig, fft_size, hop, w, n_frames, onesided,
                                                    T, ab_stft),
                             stft_vmem.stft_frames_plain(sig, fft_size, hop, w, n_frames,
                                                         onesided))
                require(s_t >= GATE_PLAIN_DB, f"stft_frames T={T} vs plain {s_t:.1f} dB")
        runs = {T: [] for T in arms}
        for T in arms + arms[::-1]:
            runs[T].append(time_ms(lambda: stft_vmem._launch_stft(
                sig, fft_size, hop, w, n_frames, True, T, ab_stft), graph=True))
        for T, rs in runs.items():
            ms[f"ab_stft_T{T}{tag}"] = statistics.mean(rs)
            shapes[f"ab_stft_T{T}{tag}"] = (1, STFT_N)
        print(f"A/B stft_frames {fft_size}/{hop} T: "
              + ", ".join(f"T={T} {rs} ms" for T, rs in runs.items())
              + f"; default T={stft_vmem.frames_per_block(fft_size)}, faster "
              f"T={min(runs, key=lambda T: statistics.mean(runs[T]))} [{card}]")
        ms["stft_frames_plain" + tag] = time_ms(
            lambda: stft_vmem.stft_frames_plain(sig, fft_size, hop, w, n_frames))
        ref = torch.stft(sig, fft_size, hop, window=w, center=False, return_complex=True)
        s_ref = snr_db(stft_vmem.stft_frames(sig, fft_size, hop, w, n_frames),
                       (ref.real.T, ref.imag.T))
        require(s_ref >= GATE_PLAIN_DB, f"stft_frames vs torch.stft {s_ref:.1f} dB")
        shapes.update(dict.fromkeys(("stft_frames" + tag, "stft_frames_graph" + tag,
                                     "stft_frames_plain" + tag, "cufft_stft" + tag,
                                     "cufft_stft_graph" + tag), (1, STFT_N)))
    # the huge-n kernels at the main shapes: one 2^24 transform (bench.py
    # fft_16m_single), 4 x 2^22, and the pipeline at 16 x 2^20
    B, n = HUGE_MAIN_SHAPE
    xr, xi = planes(B, n)
    a = threestep_vmem.threestep_pass_a(xr, xi)
    b = threestep_vmem.threestep_pass_b(*a)
    xc = torch.complex(xr, xi)
    ms["three_pass"] = time_ms(lambda: threestep_vmem.fft_split_huge(xr, xi))
    ms["three_pass_plain"] = time_ms(lambda: threestep_vmem.fft_split_huge_plain(xr, xi))
    ms["threestep_pass_a"] = time_ms(lambda: threestep_vmem.threestep_pass_a(xr, xi))
    ms["threestep_pass_a_plain"] = time_ms(
        lambda: threestep_vmem.threestep_pass_a_plain(xr, xi))
    ms["threestep_pass_b"] = time_ms(lambda: threestep_vmem.threestep_pass_b(*a))
    ms["threestep_pass_b_plain"] = time_ms(lambda: threestep_vmem.threestep_pass_b_plain(*a))
    ms["threestep_pass_c"] = time_ms(lambda: threestep_vmem.threestep_pass_c(*b))
    ms["threestep_pass_c_plain"] = time_ms(lambda: threestep_vmem.threestep_pass_c_plain(*b))
    ms["cufft_16m"] = time_ms(lambda: torch.fft.fft(xc))
    ms["einsum_16m"] = time_ms(lambda: fft_split(xr, xi))
    shapes.update(dict.fromkeys(
        ("three_pass", "three_pass_plain", "threestep_pass_a", "threestep_pass_a_plain",
         "threestep_pass_b", "threestep_pass_b_plain", "threestep_pass_c",
         "threestep_pass_c_plain", "cufft_16m", "einsum_16m"), HUGE_MAIN_SHAPE))
    print(f"1 x 2^24: three_pass {ms['three_pass']:.4f} ms, einsum route "
          f"{ms['einsum_16m']:.4f} ms, cuFFT {ms['cufft_16m']:.4f} ms [{card}]")
    del xr, xi, a, b, xc
    B, n = HUGE_AUTO_SHAPES[0]
    ur, ui = planes(B, n)
    uc = torch.complex(ur, ui)
    ms["three_pass_4x2^22"] = time_ms(lambda: threestep_vmem.fft_split_huge(ur, ui))
    ms["three_pass_4x2^22_plain"] = time_ms(
        lambda: threestep_vmem.fft_split_huge_plain(ur, ui))
    ms["cufft_4x2^22"] = time_ms(lambda: torch.fft.fft(uc))
    shapes.update(dict.fromkeys(("three_pass_4x2^22", "three_pass_4x2^22_plain",
                                 "cufft_4x2^22"), (B, n)))
    del ur, ui, uc
    B, n = PIPELINE_SHAPE
    factors = stage_fused.pipeline_factors(n)
    pr, pi = planes(B, n)
    r1, r2, leaf = factors
    s1r, s1i = (t.reshape(B * r1, n // r1) for t in stage_fused.fused_stage(pr, pi, r1))
    s2r, s2i = (t.reshape(B, n) for t in stage_fused.swap_stage(s1r, s1i, r2, r1))
    ms["stage_pipeline"] = time_ms(
        lambda: stage_fused.fft_split_pipeline(pr, pi, FORWARD, factors))
    ms["stage_pipeline_plain"] = time_ms(
        lambda: stage_fused.fft_split_pipeline_plain(pr, pi, FORWARD, factors))
    ms["fused_stage"] = time_ms(lambda: stage_fused.fused_stage(pr, pi, r1))
    ms["fused_stage_plain"] = time_ms(lambda: stage_fused.fused_stage_plain(pr, pi, r1))
    ms["fused_stage_2"] = time_ms(lambda: stage_fused.swap_stage(s1r, s1i, r2, r1))
    ms["fused_stage_2_plain"] = time_ms(
        lambda: stage_fused.swap_stage_plain(s1r, s1i, r2, r1))
    ms["stage_leaf"] = time_ms(lambda: stage_fused.stage_leaf(s2r, s2i, leaf))
    ms["stage_leaf_plain"] = time_ms(lambda: stage_fused.stage_leaf_plain(s2r, s2i, leaf))
    shapes.update(dict.fromkeys(("stage_pipeline", "stage_pipeline_plain", "fused_stage",
                                 "fused_stage_plain", "fused_stage_2", "fused_stage_2_plain",
                                 "stage_leaf", "stage_leaf_plain"),
                                PIPELINE_SHAPE))
    print(f"16 x 2^20 pipeline {factors}: {ms['stage_pipeline']:.4f} ms, stages "
          f"{ms['fused_stage']:.4f} + {ms['fused_stage_2']:.4f} ms, leaf "
          f"{ms['stage_leaf']:.4f} ms, cuFFT {ms['cufft_1m']:.4f} ms [{card}]")
    del pr, pi, s1r, s1i, s2r, s2i
    for name, t in ms.items():
        shape = shapes.get(name, MAIN_SHAPE)
        gsps = shape[0] * shape[1] / (t * 1e6)
        print(f"time {name} {shape[0]}x{shape[1]}: {t:.4f} ms "
              f"({gsps:.2f} GS/s) [{card}]")
    # the DSP entry points of phase 4f, each beside the PyTorch call that
    # computes the same function, both timed alike; the bound is the
    # entry point's bytes in and out over 3.35 TB/s
    t_dsp = time.perf_counter()
    for name, shape, fn, lib_name, lib_fn, nbytes in dsp_cases:
        t_fn = time_ms(fn, **DSP_TIMING)
        lib = (f"{lib_name} {time_ms(lib_fn, **DSP_TIMING):.4f} ms" if lib_fn
               else "no PyTorch call computes it")
        print(f"time dsp {name} {shape}: {t_fn:.4f} ms; {lib}; bound "
              f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes) [{card}]")
    print(f"DSP timing: {time.perf_counter() - t_dsp:.1f} s")
    del dsp_cases

    # phase 6: the result. Each kernel's bound at its timed shape: the
    # larger of its bytes in and out (each input read once, each output
    # written once; tables excluded) over 3.35 TB/s and its float32
    # operations (5 N log2 L for the length-L FFTs it runs on N points,
    # 6 N for a fused complex multiply) over 67 TFLOP/s
    def bound(nbytes, flops):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    lg = lambda v: v.bit_length() - 1
    N = math.prod(MAIN_SHAPE)
    L1, L2 = fourstep_vmem._split_sides(MAIN_SHAPE[1])
    Nr, n_row = math.prod(ROWS_MAIN_SHAPE), ROWS_MAIN_SHAPE[1]
    Nf, n_f = math.prod(FILTER_ROWS_MAIN_SHAPE), FILTER_ROWS_MAIN_SHAPE[1]
    fsz = plan.kernel_fft_size()
    os_frames = -(-SERVING_N // (fsz - (SERVING_TAPS - 1)))
    Nreal, m_half = math.prod(RFFT_SHAPE), RFFT_SHAPE[1] // 2
    h1, h2 = fourstep_vmem._split_sides(m_half)
    bins_half = RFFT_SHAPE[0] * m_half
    fft_size, hop = STFT_CASES[0]
    st_frames, st_bins = (STFT_N - fft_size) // hop + 1, fft_size // 2 + 1
    Nh = math.prod(HUGE_MAIN_SHAPE)
    F1, F2, F3 = threestep_vmem._split_three(HUGE_MAIN_SHAPE[1])
    Np = math.prod(PIPELINE_SHAPE)
    r1, _, leaf_p = stage_fused.pipeline_factors(PIPELINE_SHAPE[1])
    ts = "fftlab/kernels/threestep_vmem.py:"
    # name, source, replaces, also_replaces, launches, timed, library, bytes, flops
    table = [
        ("fft_rows", "fft_rows.cu", "fftlab/kernels/fft_vmem.py:176", None, fft_launches,
         "fft_rows", "cufft_16k", 16 * Nr, 5 * Nr * lg(n_row)),
        ("fourstep_pass1", "fourstep.cu", "fftlab/kernels/fourstep_vmem.py:584",
         "fftlab/kernels/resident_vmem.py:433", fft_launches, "fourstep_pass1", None,
         16 * N, 5 * N * lg(L1) + 6 * N),
        ("fourstep_pass2", "fourstep.cu", "fftlab/kernels/fourstep_vmem.py:628",
         "fftlab/kernels/resident_vmem.py:433", fft_launches, "fourstep_pass2", None,
         16 * N, 5 * N * lg(L2)),
        # the middle step of the sandwich: the forward and inverse row FFTs,
        # H and the inverse twiddle
        ("fourstep_pass2_sandwich", "fourstep.cu", "fftlab/kernels/resident_vmem.py:883",
         "fftlab/kernels/fourstep_vmem.py:628", filter_launches, "fourstep_pass2_sandwich",
         None, 16 * N + 8 * MAIN_SHAPE[1], 10 * N * lg(L2) + 12 * N),
        ("filter_rows", "filter.cu", "fftlab/kernels/fft_vmem.py:247", None,
         filter_launches, "filter_rows", None, 16 * Nf + 8 * n_f,
         10 * Nf * lg(n_f) + 6 * Nf),
        ("os_filter", "filter.cu", "fftlab/kernels/os_filter_vmem.py:96",
         "fftlab/kernels/os_filter_vmem.py:213", filter_launches, "os_filter", "conv1d_fir",
         16 * SERVING_N + 8 * fsz, os_frames * (10 * fsz * lg(fsz) + 6 * fsz)),
        ("pack_real", "real.cu", "fftlab/kernels/rfft_vmem.py:99", None, real_launches,
         "pack_real", None, 8 * Nreal, 0),
        ("interleave", "real.cu", "fftlab/kernels/rfft_vmem.py:126", None, real_launches,
         "interleave", "stack_interleave", 8 * Nreal, 0),
        ("herm_unpack", "real.cu", "fftlab/kernels/rfft_vmem.py:250",
         "fftlab/kernels/rfft_resident.py:284", real_launches, "herm_unpack", None,
         16 * bins_half + 8 * RFFT_SHAPE[0], 10 * bins_half),
        ("herm_repack", "real.cu", "fftlab/kernels/rfft_resident.py:485", None,
         real_launches, "herm_repack", None, 16 * bins_half + 8 * RFFT_SHAPE[0],
         10 * bins_half),
        ("fourstep_pass1_packed", "fourstep.cu", "fftlab/kernels/rfft_resident.py:284",
         "fftlab/kernels/rfft_vmem.py:99", real_launches, "fourstep_pass1_packed", None,
         8 * Nreal, 5 * bins_half * lg(h1) + 6 * bins_half),
        ("fourstep_pass2_interleaved", "fourstep.cu", "fftlab/kernels/rfft_resident.py:485",
         "fftlab/kernels/rfft_vmem.py:126", real_launches, "fourstep_pass2_interleaved",
         None, 8 * Nreal, 5 * bins_half * lg(h2)),
        ("fourstep_pass2_unpack", "fourstep.cu", "fftlab/kernels/rfft_resident.py:284",
         "fftlab/kernels/rfft_vmem.py:250", real_launches, "fourstep_pass2_unpack", None,
         16 * bins_half + 8 * RFFT_SHAPE[0], 5 * bins_half * lg(h2) + 10 * bins_half),
        ("stft_frames", "real.cu", "fftlab/kernels/stft_vmem.py:77",
         "fftlab/kernels/stft_vmem.py:174", real_launches, f"stft_frames_{fft_size}_{hop}",
         f"cufft_stft_{fft_size}_{hop}", 4 * STFT_N + 8 * st_frames * st_bins,
         st_frames * (5 * (fft_size // 2) * lg(fft_size // 2) + 10 * st_bins + fft_size)),
        ("threestep_pass_a", "fourstep.cu", ts + "204", ts + "387", huge_launches,
         "threestep_pass_a", None, 16 * Nh, 5 * Nh * lg(F1) + 6 * Nh),
        ("threestep_pass_b", "fourstep.cu", ts + "233", ts + "414", huge_launches,
         "threestep_pass_b", None, 16 * Nh, 5 * Nh * lg(F2) + 6 * Nh),
        ("threestep_pass_c", "fourstep.cu", ts + "256", ts + "440", huge_launches,
         "threestep_pass_c", None, 16 * Nh, 5 * Nh * lg(F3)),
        ("fused_stage", "fourstep.cu", "fftlab/kernels/stage_fused.py:96", None,
         huge_launches, "fused_stage", None, 16 * Np, 5 * Np * lg(r1) + 6 * Np),
        # the leaf contraction and digit reversal, which the JAX package
        # runs outside any Pallas kernel, on pass 2's leaf mode
        ("stage_leaf", "fourstep.cu", "fftlab/kernels/stage_fused.py:167",
         "fftlab/kernels/stage_fused.py:176", huge_launches, "stage_leaf", None, 16 * Np,
         5 * Np * lg(leaf_p)),
    ]
    src = "fftlab_torch/csrc/"
    kernels = []
    for name, source, replaces, also, launches, timed, library, nbytes, flops in table:
        entry = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces}
        if also:
            entry["also_replaces"] = also
        bound_ms, bound_by = bound(nbytes, flops)
        # the sharded paths (phase 4h) and the entries (4i) are main paths of their own
        entry.update({"launches": launches[name] + dist_launches.get(name, 0)
                      + entry_launches.get(name, 0),
                      "max_abs_err": err[name],
                      "ms": ms[timed], "plain_ms": ms[timed.replace(name, name + "_plain")],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": ms[library] if library else None})
        kernels.append(entry)
        print(f"kernel {name}: {ms[timed]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms[timed]:.1%} of it [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
