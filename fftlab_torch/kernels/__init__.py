"""Hand-written Hopper CUDA kernels (sources in fftlab_torch/csrc) and,
beside each, its plain tensor-op version. Nothing CUDA-specific is
touched at import: the kernel library is built and loaded at the first
launch."""
