"""Measurement (counterpart of fftlab/bench/): `timing` for measured plan
selection, and the benchmark harness (warm-up and timed calls, accuracy
gates, roofline accounting)."""

from fftlab_torch.bench.harness import (
    BenchResult,
    benchmark_algorithm,
    benchmark_suite,
    complexity_exponent,
    print_table,
    roofline,
    time_fn,
)
