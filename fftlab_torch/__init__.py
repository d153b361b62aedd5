"""fftlab_torch: the PyTorch/CUDA port of fftlab's split-plane FFT.

Imports torch and never jax; the JAX package `fftlab` is the reference
the port is tested against. Split re/im float32 planes [..., n],
batch-first; forward unscaled, inverse 1/n, natural-order output. On a
CUDA tensor the kernel routes launch hand-written Hopper (sm_90a) CUDA
kernels, built from `fftlab_torch/csrc` at first use; on a CPU tensor
they run each kernel's plain tensor-op version.
"""

from fftlab_torch.algos.split_stockham import fft_split, ifft_split
from fftlab_torch.core.types import FORWARD, INVERSE, Direction
from fftlab_torch.plan.api import plan_dft_1d_split, plan_from_jax
from fftlab_torch.plan.dispatch import fft_split_auto, select_split_impl

__all__ = [
    "Direction",
    "FORWARD",
    "INVERSE",
    "fft_split",
    "fft_split_auto",
    "ifft_split",
    "plan_dft_1d_split",
    "plan_from_jax",
    "select_split_impl",
]
