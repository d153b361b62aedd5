"""Real-input (r2c) and real-output (c2r) transforms on complex tensors
(counterpart of fftlab/algos/real_fft.py), numpy's conventions:

  rfft:  real [..., n] -> complex [..., n/2+1]  (forward basis e^{-2*pi*i*jk/n})
  irfft: complex [..., n/2+1] -> real [..., n], scaled by 1/n.

Even n >= 4 packs two reals into one complex sample: one n/2-point
complex FFT (`cfft`, the Stockham matmul FFT by default) and an O(n)
Hermitian unpack. Odd or small n runs a complex FFT of the promoted
input.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos._common import table
from fftlab_torch.core.types import Direction, as_tensor, complex_dtype_for, real_dtype_for


def _default_cfft():
    from fftlab_torch.algos.stockham import stockham_fft

    return stockham_fft


def _half_twiddle_np(n: int, direction: int) -> np.ndarray:
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return np.exp(2j * np.pi * float(direction) * k / n)


def rfft(x, cfft=None):
    """Real-to-complex FFT of the last axis; returns n//2+1 bins.

    Even n: z[j] = x[2j] + i*x[2j+1], Z = FFT_{n/2}(z), then
      E[k] = (Z[k] + conj(Z[-k]))/2,  O[k] = (Z[k] - conj(Z[-k]))/(2i),
      X[k] = E[k] + W_n^k * O[k]."""
    x = as_tensor(x)
    if x.is_complex():
        raise TypeError("rfft expects real input; use fft() for complex data")
    n = int(x.shape[-1])
    if cfft is None:
        cfft = _default_cfft()
    h = n // 2 + 1
    cdtype = complex_dtype_for(x.dtype)
    if n % 2 or n < 4:
        return cfft(x.to(cdtype), Direction.FORWARD)[..., :h]
    xr = x.to(real_dtype_for(cdtype))
    z = torch.complex(xr[..., 0::2], xr[..., 1::2])
    Z = cfft(z, Direction.FORWARD)  # [..., n/2]
    Zext = torch.cat([Z, Z[..., :1]], dim=-1)  # Zext[n/2] = Z[0]
    Zrev = torch.conj(torch.flip(Zext, (-1,)))  # conj(Z[(n/2 - k) mod n/2])
    E = 0.5 * (Zext + Zrev)
    O = -0.5j * (Zext - Zrev)
    return E + table(_half_twiddle_np, n, int(Direction.FORWARD), like=Zext) * O


def irfft(X, n: int | None = None, cfft=None):
    """Complex-to-real inverse FFT (Hermitian input, n//2+1 bins -> n
    reals, 1/n scaled): the packing inverted, Z = E + i*O with O from the
    inverse twiddle, one n/2-point inverse complex FFT, re-interleaved."""
    X = as_tensor(X)
    h = int(X.shape[-1])
    if n is None:
        n = 2 * (h - 1)
    if cfft is None:
        cfft = _default_cfft()
    rdtype = real_dtype_for(X.dtype)
    if n % 2 or n < 4:
        # the full Hermitian spectrum, then a complex inverse FFT
        tail = torch.conj(torch.flip(X[..., 1 : n - h + 1], (-1,)))
        full = torch.cat([X[..., :h], tail], dim=-1)
        return cfft(full, Direction.INVERSE).real.to(rdtype)
    Xrev = torch.conj(torch.flip(X, (-1,)))  # X at index n/2 - k
    E = 0.5 * (X + Xrev)
    O = 0.5 * (X - Xrev) * table(_half_twiddle_np, n, int(Direction.INVERSE), like=X)
    Z = (E + 1j * O)[..., : n // 2]
    z = cfft(Z, Direction.INVERSE)  # the packed sequence, 1/(n/2) scaled
    out = torch.stack([z.real, z.imag], dim=-1)
    return out.reshape(*out.shape[:-2], n).to(rdtype)


def rfftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Bin center frequencies of the rfft output (host-side)."""
    return np.arange(n // 2 + 1, dtype=np.float64) / (n * d)
