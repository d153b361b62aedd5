"""fftlab_torch: the PyTorch/CUDA port of fftlab.

Imports torch and never jax; the JAX package `fftlab` is the reference
the port is tested against. Two APIs, as in the JAX package:

- the complex-dtype API (`fft`, `ifft`, `plan_dft_1d`, `rfft`, `fft2`,
  ...): complex64/complex128 tensors [..., n], the algorithm registry
  (`algos.build_registry`) and the planner with ESTIMATE, MEASURE,
  PATIENT, EXHAUSTIVE, WISDOM_ONLY and wisdom;
- the split-plane API (`fft_split`, `plan_dft_1d_split`, ...): float32
  (re, im) planes [..., n] up to 2^26 points, the spectral filter and the
  real-signal path.

Batch-first; forward unscaled, inverse 1/n, natural-order output. On a
CUDA tensor the kernel routes launch hand-written Hopper (sm_90a) CUDA
kernels, built from `fftlab_torch/csrc` at first use; on a CPU tensor
they run each kernel's plain tensor-op version. Input that is not a
tensor goes to the card unless the caller passes `device="cpu"`.

The import, top to bottom, is the set-up span `import` of the recorder
(`utils.trace.setup_spans()`).
"""

import time as _time

_IMPORT_START = _time.time_ns()

from fftlab_torch.utils import trace as _trace  # noqa: E402

_IMPORT = _trace.setup_begin("import", _IMPORT_START)

from fftlab_torch.algos.bluestein import bluestein_fft_split  # noqa: E402
from fftlab_torch.algos.fft2d import fft2, fftshift, ifft2, ifftshift  # noqa: E402
from fftlab_torch.algos.real_fft import irfft, rfft  # noqa: E402
from fftlab_torch.algos.split_stockham import (fft2_split, fft_split, from_split,  # noqa: E402
                                               ifft_split, irfft_split, rfft_split,
                                               spectral_filter_split, to_split)
from fftlab_torch.core.types import FORWARD, INVERSE, Direction  # noqa: E402
from fftlab_torch.dsp.filtering import FilterParams, FilterType, fft_filter_split  # noqa: E402
from fftlab_torch.dsp.spectrum import coherence_split, welch_psd_split  # noqa: E402
from fftlab_torch.dsp.stft import istft_split, stft_split  # noqa: E402
from fftlab_torch.kernels.fourstep_vmem import (fft_split_large, irfft_split_large,  # noqa: E402
                                                rfft_split_large, spectral_filter_large)
from fftlab_torch.kernels.threestep_vmem import fft_split_huge  # noqa: E402
from fftlab_torch.plan.api import (execute, fft, fft_auto, ifft, plan_c2r_1d,  # noqa: E402
                                   plan_c2r_1d_split, plan_dft_1d, plan_dft_1d_split,
                                   plan_dft_2d, plan_from_jax, plan_r2c_1d,
                                   plan_r2c_1d_split)
from fftlab_torch.plan.dispatch import (  # noqa: E402
    fft_split_auto,
    select_filter_impl,
    select_split_impl,
    spectral_filter_auto,
)
from fftlab_torch.plan.filter_plan import FilterPlan  # noqa: E402

_trace.setup_end(_IMPORT)

__all__ = [
    # fftlab.__all__, in its order
    "Direction",
    "FORWARD",
    "INVERSE",
    "fft",
    "ifft",
    "fft_auto",
    "plan_dft_1d",
    "plan_dft_1d_split",
    "plan_r2c_1d",
    "plan_c2r_1d",
    "plan_r2c_1d_split",
    "plan_c2r_1d_split",
    "plan_dft_2d",
    "execute",
    "rfft",
    "irfft",
    "fft2",
    "ifft2",
    "fftshift",
    "ifftshift",
    "fft_split",
    "ifft_split",
    "rfft_split",
    "irfft_split",
    "spectral_filter_split",
    "to_split",
    "from_split",
    "FilterPlan",
    "fft_split_auto",
    "select_split_impl",
    "fft_split_large",
    "rfft_split_large",
    "irfft_split_large",
    "spectral_filter_large",
    "fft_split_huge",
    # the port's own
    "FilterParams",
    "FilterType",
    "bluestein_fft_split",
    "coherence_split",
    "fft2_split",
    "fft_filter_split",
    "istft_split",
    "plan_from_jax",
    "select_filter_impl",
    "spectral_filter_auto",
    "stft_split",
    "welch_psd_split",
]
