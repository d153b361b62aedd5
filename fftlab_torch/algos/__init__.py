"""Transform algorithms in tensor ops, and the registry of the complex
algorithms (counterpart of fftlab/algos/__init__.py).

Every registry transform has the signature ``fn(x, direction=FORWARD)``
over the last axis of a complex tensor [..., n]; forward unscaled,
inverse 1/n. `build_registry` holds the JAX package's 13 entries, under
the same names, size predicates and order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from fftlab_torch.core.types import is_power_of, is_power_of_two


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    name: str
    fn: Callable  # fn(x, direction=FORWARD)
    supports: Callable[[int], bool]  # size predicate
    description: str = ""


def _any_size(n: int) -> bool:
    return n >= 1


def _pow2(n: int) -> bool:
    return is_power_of_two(n)


def _pow4(n: int) -> bool:
    return is_power_of(n, 4)


def _composite(n: int) -> bool:
    """A nontrivial n = n1*n2 split exists (any non-prime n > 3)."""
    from fftlab_torch.algos.mixed_radix import is_prime

    return n >= 4 and not is_prime(n)


def build_registry() -> dict:
    from fftlab_torch.algos import (bluestein, dft, iterative, mixed_radix, radix2,
                                    radix4, recursive, split_radix, stockham)
    from fftlab_torch.dist.four_step import four_step_fft
    from fftlab_torch.kernels.fft_vmem import pallas_fft, supported_size

    specs = [
        AlgoSpec("naive_dft", dft.naive_dft, _any_size, "O(n^2) oracle (matmul)"),
        AlgoSpec("optimized_dft", dft.optimized_dft, _any_size, "cached-twiddle DFT"),
        AlgoSpec("radix2_dit", radix2.radix2_dit, _pow2, "iterative Cooley-Tukey DIT"),
        AlgoSpec("radix2_dif", radix2.radix2_dif, _pow2, "decimation in frequency"),
        AlgoSpec("radix4", radix4.radix4_fft, _pow4, "genuine radix-4 butterflies"),
        AlgoSpec("split_radix", split_radix.split_radix_fft, _pow2, "genuine split-radix"),
        AlgoSpec("bluestein", bluestein.bluestein_fft, _any_size, "chirp-z, arbitrary n"),
        AlgoSpec("mixed_radix", mixed_radix.mixed_radix_fft, _any_size,
                 "general factorization"),
        AlgoSpec("recursive", recursive.recursive_fft, _pow2, "educational divide&conquer"),
        AlgoSpec("iterative", iterative.iterative_fft, _pow2, "annotated pedagogical DIT"),
        AlgoSpec("stockham_mxu", stockham.stockham_fft, stockham.supports,
                 "mixed-radix matmul FFT"),
        AlgoSpec("pallas_vmem", pallas_fft, supported_size,
                 "the row kernel fft_rows (n = m*128)"),
        AlgoSpec("four_step", four_step_fft, _composite, "two-level n1 x n2 decomposition"),
    ]
    return {s.name: s for s in specs}
