"""The Q15 fixed-point FFT (native/q15_fft.cpp through ctypes; counterpart
of fftlab/native/q15.py): Q15 int16 samples, a >>1 block scaling per
stage, block-floating-point normalisation. `algos/lowprec.snr_vs_oracle`
reports it beside the reduced-precision modes."""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab_torch.core.types import to_host
from fftlab_torch.native.lib import load_native_lib


def float_to_q15(x) -> np.ndarray:
    """[-1, 1) floats -> Q15 int16, saturating."""
    a = np.asarray(to_host(x), dtype=np.float64)
    return np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16)


def q15_to_float(q) -> np.ndarray:
    return np.asarray(to_host(q), dtype=np.float64) / 32768.0


def _int16_copy(a) -> np.ndarray:
    return np.ascontiguousarray(to_host(a), dtype=np.int16).copy()


def q15_fft(re, im, inverse: bool = False) -> tuple[np.ndarray, np.ndarray, int]:
    """Q15 FFT of 1-D int16 planes; returns new (re, im, block_exponent).

    The spectrum is q15_to_float(out) * 2**block_exponent (forward). Each
    direction shifts right once per stage, so a forward and inverse round
    trip carries the 1/n itself, up to Q15 noise."""
    lib = load_native_lib()
    r, i = _int16_copy(re), _int16_copy(im)
    if r.shape != i.shape or r.ndim != 1:
        raise ValueError("q15_fft expects matching 1D int16 arrays")
    n = len(r)
    rc = lib.fftlab_q15_fft(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n, 1 if inverse else 0)
    if rc < 0:
        raise ValueError(f"q15_fft: n={n} must be a power of two >= 2")
    return r, i, rc


def q15_normalize(re, im) -> tuple[np.ndarray, np.ndarray, int]:
    """Block-floating-point normalisation; returns (re, im, left_shifts)."""
    lib = load_native_lib()
    r, i = _int16_copy(re), _int16_copy(im)
    shifts = lib.fftlab_q15_normalize(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(r))
    return r, i, shifts


def q15_fft_float(x, inverse: bool = False) -> np.ndarray:
    """Complex float in, complex128 out; the input must satisfy |x| < 1.

    The per-stage shifts make the kernel compute DFT/n both ways: the
    forward multiplies the block exponent (2^log2 n = n) back in, the
    unscaled spectrum; for the inverse DFT/n is already the 1/n-scaled
    result, so the exponent is not applied."""
    x = np.asarray(to_host(x), dtype=np.complex128)
    r, i, exp = q15_fft(float_to_q15(x.real), float_to_q15(x.imag), inverse)
    scale = 1.0 if inverse else float(2 ** exp)
    return (q15_to_float(r) + 1j * q15_to_float(i)) * scale
