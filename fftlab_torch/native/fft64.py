"""The float64 host FFT (native/fft64.cpp through ctypes; counterpart of
fftlab/native/fft64.py): C++ double precision on batch-first split
planes, power-of-two sizes only. A third implementation beside numpy's
and the port's, and the leg of `plan.api.plan_dft_1d_native`."""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab_torch.core.types import to_host
from fftlab_torch.native.lib import load_native_lib


def fft64_split(re, im, inverse: bool = False):
    """Batched c2c FFT on split float64 planes [..., n] (numpy or tensors).

    Forward unscaled / inverse 1/n. Returns new (re, im) float64 numpy
    arrays of the input shape; the inputs are not written."""
    # np.array(copy=True): one fresh contiguous buffer per plane
    re = np.array(to_host(re), dtype=np.float64, order="C")
    im = np.array(to_host(im), dtype=np.float64, order="C")
    if re.shape != im.shape:
        raise ValueError(f"plane shapes differ: {re.shape} vs {im.shape}")
    if re.ndim == 0:
        raise ValueError("fft64_split expects [..., n] arrays")
    n = int(re.shape[-1])
    batch = int(np.prod(re.shape[:-1], dtype=np.int64)) if re.ndim > 1 else 1
    lib = load_native_lib()
    rc = lib.fftlab_fft64(
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        batch, n, 1 if inverse else 0)
    if rc != 0:
        raise ValueError(f"native fft64 rejected n={n} (power-of-two sizes only)")
    return re, im


def fft64(x, inverse: bool = False) -> np.ndarray:
    """Complex128 [..., n] in (numpy or a tensor) and out (numpy)."""
    x = to_host(x)
    re, im = fft64_split(x.real, x.imag, inverse=inverse)
    return re + 1j * im
