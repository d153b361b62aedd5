"""Small-N DFT codelets for the mixed-radix path (counterpart of
fftlab/algos/codelets.py).

Each codelet transforms axis -2 of a [..., p, m] tensor (p = radix):
the explicit minimal-operation formula for p in {2, 3, 5}, one complex
matmul against the p x p DFT matrix otherwise. Direction enters through
s = i*direction.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos._common import table
from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np
from fftlab_torch.core.types import Direction


def dft2(x, direction):
    """2-point butterfly: [a+b, a-b]."""
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([a + b, a - b], dim=-2)


def dft3(x, direction):
    """3-point DFT. With u = x1+x2, v = x1-x2:
      X0 = x0 + u,  X1,2 = x0 - u/2 +- i*dir*sin(2*pi/3)*v."""
    s = complex(1j * float(int(direction)) * np.sin(2 * np.pi / 3))
    x0, x1, x2 = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    u = x1 + x2
    v = x1 - x2
    w = x0 - 0.5 * u
    sv = s * v
    return torch.stack([x0 + u, w + sv, w - sv], dim=-2)


def dft5(x, direction):
    """5-point Winograd-style DFT with c1 = cos(2*pi/5), c2 = cos(4*pi/5),
    s1 = sin(2*pi/5), s2 = sin(4*pi/5)."""
    d = float(int(direction))
    c1, c2 = np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5)
    s1, s2 = np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5)
    x0 = x[..., 0, :]
    x1, x2, x3, x4 = x[..., 1, :], x[..., 2, :], x[..., 3, :], x[..., 4, :]
    t1 = x1 + x4
    t2 = x2 + x3
    t3 = x1 - x4
    t4 = x2 - x3
    m1 = x0 + c1 * t1 + c2 * t2
    m2 = x0 + c2 * t1 + c1 * t2
    n1 = complex(1j * d * s1) * t3 + complex(1j * d * s2) * t4
    n2 = complex(1j * d * s2) * t3 - complex(1j * d * s1) * t4
    return torch.stack([x0 + t1 + t2, m1 + n1, m2 + n2, m2 - n2, m1 - n1], dim=-2)


def dft_general(x, p: int, direction):
    """General radix-p DFT over axis -2 as one complex matmul against the
    p x p DFT matrix (F is symmetric, so F @ x contracts its rows)."""
    F = table(dft_matrix_np, p, Direction(int(direction)), like=x)
    with full_float32():
        return torch.matmul(F, x)


def apply_codelet(x, p: int, direction):
    """The explicit codelet for p in {2, 3, 5}, the matmul otherwise.
    x: [..., p, m]."""
    if p == 2:
        return dft2(x, direction)
    if p == 3:
        return dft3(x, direction)
    if p == 5:
        return dft5(x, direction)
    return dft_general(x, p, direction)
