"""Reference DFTs: the O(n^2) oracle, the cached-twiddle variant, and
single-bin evaluators (counterpart of fftlab/algos/dft.py:25-104).

The DFT is one complex matmul against the n x n DFT matrix, at full
float32 (`core/precision.py full_float32`): on the card complex64 runs
as CGEMM, where TF32 would cost about 60 dB.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos._common import const, inverse_scale, prepare, table
from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np
from fftlab_torch.core.types import FORWARD, Direction, as_complex_array, as_tensor


def _matmul(x: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    with full_float32():
        return torch.matmul(x, F)


def naive_dft(x, direction=FORWARD):
    """Textbook O(n^2) DFT: X[k] = sum_j x[j] * exp(2*pi*i*dir*j*k/n), as
    one matmul against the DFT matrix."""
    x, n, direction = prepare(x, direction)
    y = _matmul(x, table(dft_matrix_np, n, direction, like=x))
    return inverse_scale(y, n, direction)


def _half_dft_np(n: int, direction: int) -> np.ndarray:
    return dft_matrix_np(n, direction)[:, : n // 2 + 1]


def optimized_dft(x, direction=FORWARD):
    """Cached-twiddle DFT with a real-input half-spectrum path: for real
    input only n/2+1 bins are computed and the rest mirrored by Hermitian
    symmetry; for complex input the same matmul as `naive_dft`."""
    xin = as_tensor(x)
    if not xin.is_complex():
        return _real_input_dft(xin, direction)
    return naive_dft(xin, direction)


def _real_input_dft(x, direction):
    x, n, direction = prepare(x, direction)
    h = n // 2 + 1
    half = _matmul(x, table(_half_dft_np, n, int(direction), like=x))  # bins 0..n/2
    if n > 1:
        mirror = torch.conj(torch.flip(half[..., 1 : n - h + 1], (-1,)))
        y = torch.cat([half, mirror], dim=-1)
    else:
        y = half
    return inverse_scale(y, n, direction)


def goertzel(x, k, direction=FORWARD):
    """Goertzel single-bin DFT: X[k] via the second-order recurrence
    s[j] = x[j] + 2*cos(w)*s[j-1] - s[j-2], one step per sample in a loop
    over the last axis, vectorised over the batch and over the bins: `k`
    an int gives [...], a sequence of bins gives [..., len(k)]."""
    x = as_complex_array(x)
    n = int(x.shape[-1])
    direction = Direction(int(direction))
    ks = np.atleast_1d(np.asarray(k, dtype=np.float64))
    w = 2.0 * np.pi * ks / n
    coeff = torch.from_numpy(2.0 * np.cos(w)).to(x.device, x.real.dtype)
    s1 = x.new_zeros((*x.shape[:-1], len(ks)))
    s2 = torch.zeros_like(s1)
    for j in range(n):
        s1, s2 = x[..., j, None] + coeff * s1 - s2, s1
    # Closing formula (resonator form): X[k] = exp(-2*pi*i*dir*k/n)*s[n-1] - s[n-2]
    phase = np.exp(-2j * np.pi * float(int(direction)) * ks / n)
    y = inverse_scale(const(phase, s1) * s1 - s2, n, direction)
    return y if np.ndim(k) else y[..., 0]


def dft_bin(x, k, direction=FORWARD):
    """Direct single-bin DFT (dot with one twiddle row)."""
    x = as_complex_array(x)
    n = int(x.shape[-1])
    j = np.arange(n, dtype=np.int64)
    row = np.exp(2j * np.pi * float(int(Direction(int(direction))))
                 * np.mod(j * int(k), n) / n)
    with full_float32():
        y = torch.matmul(x, const(row, x))
    return inverse_scale(y, n, direction)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("naive_dft (oracle)", naive_dft, sizes=(16, 64, 256), device=demo_device())
