"""The port's benchmark harness (fftlab_torch.bench.harness) against
fftlab.bench.harness.

`benchmark_algorithm` and `benchmark_suite` run on the CPU at n <= 256
on the same seeded input as the JAX harness: the same rows in the same
order, round trips ok in both, and each max and RMS error against
numpy's float64 FFT at most JAX's or 1e-5, whichever is larger (both
are float32 transforms of a unit-variance input; JAX's complex einsum
reads 2.9e-5 at 256 points on this input). `complexity_exponent`,
`print_table` and `roofline` are pure arithmetic and equal JAX's on the
same results and peaks. The harness's times are host times here; the card's are CUDA
event times (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fftlab.bench import harness as jx
from fftlab_torch.bench import harness

ALGOS = ["radix2_dit", "stockham_mxu", "mixed_radix"]


@pytest.mark.parametrize("name,n", [("radix2_dit", 64), ("stockham_mxu", 256),
                                    ("bluestein", 97), ("mixed_radix", 120)])
def test_benchmark_algorithm_as_jax(name, n):
    got = harness.benchmark_algorithm(name, n, batch=2, iters=3, device="cpu")
    want = jx.benchmark_algorithm(name, n, batch=2, iters=3)
    assert (got.algorithm, got.n, got.batch) == (want.algorithm, want.n, want.batch)
    assert got.roundtrip_ok and want.roundtrip_ok
    assert got.max_error <= max(want.max_error, 1e-5)
    assert got.rms_error <= max(want.rms_error, 1e-5)
    assert got.ms > 0 and got.gsamples_per_s > 0 and got.gflops_effective > 0


def test_benchmark_algorithm_complex128():
    got = harness.benchmark_algorithm("stockham_mxu", 128, dtype=np.complex128, iters=2,
                                      device="cpu")
    assert got.roundtrip_ok and got.max_error < 1e-10


def test_benchmark_algorithm_refusals():
    with pytest.raises(ValueError):
        harness.benchmark_algorithm("radix4", 128, device="cpu")
    with pytest.raises(KeyError):
        harness.benchmark_algorithm("no_such", 128, device="cpu")


def test_benchmark_algorithm_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.benchmark_algorithm("radix2_dit", 64)


def test_benchmark_suite_as_jax():
    got = harness.benchmark_suite((16, 100, 256), ALGOS, device="cpu")
    want = jx.benchmark_suite((16, 100, 256), ALGOS)
    assert [(r.algorithm, r.n) for r in got] == [(r.algorithm, r.n) for r in want]
    assert all(r.roundtrip_ok for r in got + want)
    for a, b in zip(got, want):
        assert a.max_error <= max(b.max_error, 1e-5)


def _pair(ms):
    """The same results as the port's and as JAX's BenchResult."""
    rows = [dict(algorithm=a, n=n, batch=1, ms=t, gsamples_per_s=n / t / 1e6,
                 gflops_effective=1.0, max_error=1e-6, rms_error=1e-7, roundtrip_ok=ok)
            for (a, n, t, ok) in ms]
    return [harness.BenchResult(**r) for r in rows], [jx.BenchResult(**r) for r in rows]


ROWS = [("radix2_dit", 64, 0.01, True), ("stockham_mxu", 64, 0.008, True),
        ("radix2_dit", 256, 0.05, True), ("stockham_mxu", 256, 0.02, False),
        ("radix2_dit", 1024, 0.3, True)]


def test_table_and_exponent_equal_jax():
    mine, theirs = _pair(ROWS)
    assert harness.print_table(mine) == jx.print_table(theirs)
    sweep = [r for r in mine if r.algorithm == "radix2_dit"]
    jsweep = [r for r in theirs if r.algorithm == "radix2_dit"]
    assert harness.complexity_exponent(sweep) == jx.complexity_exponent(jsweep)
    assert np.isnan(harness.complexity_exponent(sweep[:1]))
    assert [dataclasses.asdict(r) for r in mine] == [dataclasses.asdict(r) for r in theirs]


@pytest.mark.parametrize("args", [(1 << 20, 16, 2.5e-4), (1024, 1, 1e-5), (64, 4, 3e-6)])
def test_roofline_equal_jax_at_the_same_peaks(args):
    peaks = dict(peak_flops=67e12, hbm_gbps=3350.0)
    assert harness.roofline(*args, **peaks) == jx.roofline(*args, **peaks)
    assert harness.roofline(*args, passes=2.0, dtype_bytes=16, **peaks) == \
        jx.roofline(*args, passes=2.0, dtype_bytes=16, **peaks)


def test_roofline_defaults_are_the_h100s():
    assert harness.roofline(1 << 20, 16, 2.5e-4) == \
        jx.roofline(1 << 20, 16, 2.5e-4, peak_flops=67e12, hbm_gbps=3350.0)


def test_time_fn_on_the_cpu():
    x = torch.randn(4, 256)
    sec = harness.time_fn(lambda a: a * 2.0, (x,), iters=5)
    assert 0 < sec < 1.0
    assert harness.time_fn(lambda: None, (), iters=2) >= 0


@pytest.mark.parametrize("n,iters", [(16, 200), (64, 200), (1024, 100), (16384, 50),
                                     (262144, 20), (1 << 20, 10)])
def test_iteration_counts_as_jax(n, iters):
    assert harness._iters_for(n) == jx._iters_for(n) == iters
