"""fftlab_torch: the PyTorch/CUDA port of fftlab's split-plane FFT (up to
2^26 points), spectral-filter and real-signal paths.

Imports torch and never jax; the JAX package `fftlab` is the reference
the port is tested against. Split re/im float32 planes [..., n],
batch-first; forward unscaled, inverse 1/n, natural-order output. On a
CUDA tensor the kernel routes launch hand-written Hopper (sm_90a) CUDA
kernels, built from `fftlab_torch/csrc` at first use; on a CPU tensor
they run each kernel's plain tensor-op version.
"""

from fftlab_torch.algos.bluestein import bluestein_fft_split
from fftlab_torch.algos.split_stockham import (fft_split, ifft_split, irfft_split,
                                               rfft_split)
from fftlab_torch.core.types import FORWARD, INVERSE, Direction
from fftlab_torch.dsp.filtering import FilterParams, FilterType, fft_filter_split
from fftlab_torch.dsp.spectrum import coherence_split, welch_psd_split
from fftlab_torch.dsp.stft import istft_split, stft_split
from fftlab_torch.kernels.threestep_vmem import fft_split_huge
from fftlab_torch.plan.api import (plan_c2r_1d_split, plan_dft_1d_split,
                                   plan_from_jax, plan_r2c_1d_split)
from fftlab_torch.plan.dispatch import (
    fft_split_auto,
    select_filter_impl,
    select_split_impl,
    spectral_filter_auto,
)
from fftlab_torch.plan.filter_plan import FilterPlan

__all__ = [
    "Direction",
    "FORWARD",
    "FilterParams",
    "FilterPlan",
    "FilterType",
    "INVERSE",
    "bluestein_fft_split",
    "coherence_split",
    "fft_filter_split",
    "fft_split",
    "fft_split_auto",
    "fft_split_huge",
    "ifft_split",
    "irfft_split",
    "istft_split",
    "plan_c2r_1d_split",
    "plan_dft_1d_split",
    "plan_from_jax",
    "plan_r2c_1d_split",
    "rfft_split",
    "select_filter_impl",
    "select_split_impl",
    "spectral_filter_auto",
    "stft_split",
    "welch_psd_split",
]
