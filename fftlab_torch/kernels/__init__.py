"""Hand-written Hopper CUDA kernels (sources in fftlab_torch/csrc) and,
beside each, its plain tensor-op version. Nothing CUDA-specific is
touched at import: the kernel library is built and loaded at the first
launch.

The package exports the JAX package's kernel names
(fftlab/kernels/__init__.py): each runs its kernel on a CUDA tensor and
its plain version on a CPU tensor.
"""

from fftlab_torch.kernels.fft_vmem import (
    pallas_fft,
    pallas_fft_split,
    pallas_spectral_filter,
    supported_size,
)
from fftlab_torch.kernels.stft_vmem import pallas_stft_split
from fftlab_torch.kernels.stage_fused import fused_stage, fft_split_pipeline
