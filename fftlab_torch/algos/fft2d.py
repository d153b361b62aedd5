"""2-D FFT by row-column decomposition, plus fftshift (counterpart of
fftlab/algos/fft2d.py). Both passes are batched transforms over the last
axis with one transpose between; the inverse's 1/(rows*cols) is the two
per-axis 1/n factors.
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, INVERSE


def _default_cfft():
    from fftlab_torch.algos.stockham import stockham_fft

    return stockham_fft


def fft2(x, direction=FORWARD, cfft=None):
    """2-D FFT over the last two axes of [..., rows, cols]."""
    if cfft is None:
        cfft = _default_cfft()
    x = cfft(x, direction)  # rows: transform the cols axis
    x = cfft(x.transpose(-1, -2), direction)  # cols
    return x.transpose(-1, -2)


def ifft2(x, cfft=None):
    return fft2(x, INVERSE, cfft)


def fftn(x, axes=None, direction=FORWARD, cfft=None):
    """N-D FFT over `axes` (default: all axes)."""
    if cfft is None:
        cfft = _default_cfft()
    if axes is None:
        axes = range(x.ndim)
    for ax in axes:
        x = torch.movedim(cfft(torch.movedim(x, ax, -1), direction), -1, ax)
    return x


def _axes(x, axes) -> tuple:
    if axes is None:
        return tuple(range(x.ndim))
    return (axes,) if isinstance(axes, int) else tuple(axes)


def fftshift(x, axes=None):
    """Move the zero frequency to the center."""
    axes = _axes(x, axes)
    return torch.roll(x, [x.shape[a] // 2 for a in axes], dims=axes)


def ifftshift(x, axes=None):
    axes = _axes(x, axes)
    return torch.roll(x, [-(x.shape[a] // 2) for a in axes], dims=axes)
