"""2-D image-domain FFT processing: frequency-domain ideal and Gaussian
low- and high-pass filters, high-pass edge detection, the shifted
log-magnitude spectrum and the 2-D test patterns (counterpart of
fftlab/dsp/image.py).

Masks are built on the host in float64, [rows, cols] in the unshifted
layout, with the radius grid cached per shape as in the JAX package; a
small cache keeps each mask on the device it was last used on, so a
repeated call moves no mask. The FFT -> mask -> IFFT sandwich runs on
the image's device through `algos.fft2d` and `cfft` (the tensor-op
Stockham by default). Input that is not a tensor goes to the card unless
the caller passes `device="cpu"`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fftlab_torch.algos.fft2d import fft2, fftshift, ifft2, ifftshift  # noqa: F401
from fftlab_torch.core.types import FORWARD, as_tensor, complex_dtype_for


def generate_2d_sinusoid(rows: int, cols: int, fy: float, fx: float,
                         amplitude: float = 1.0) -> np.ndarray:
    """cos(2*pi*(fy*y/rows + fx*x/cols))."""
    y = np.arange(rows, dtype=np.float64)[:, None]
    x = np.arange(cols, dtype=np.float64)[None, :]
    return amplitude * np.cos(2 * np.pi * (fy * y / rows + fx * x / cols))


def generate_2d_gaussian(rows: int, cols: int, sigma: float,
                         amplitude: float = 1.0) -> np.ndarray:
    """A centred Gaussian blob."""
    y = np.arange(rows, dtype=np.float64)[:, None] - rows / 2.0
    x = np.arange(cols, dtype=np.float64)[None, :] - cols / 2.0
    return amplitude * np.exp(-(y * y + x * x) / (2.0 * sigma * sigma))


def generate_2d_rect(rows: int, cols: int, height: int, width: int,
                     amplitude: float = 1.0) -> np.ndarray:
    """A centred rectangle."""
    img = np.zeros((rows, cols), dtype=np.float64)
    y0, x0 = (rows - height) // 2, (cols - width) // 2
    img[y0 : y0 + height, x0 : x0 + width] = amplitude
    return img


@functools.lru_cache(maxsize=None)
def _radius_grid(rows: int, cols: int) -> np.ndarray:
    """Distance from the zero-frequency bin in the unshifted layout
    (wrapped frequencies: bin k > n/2 is the negative frequency n - k)."""
    fy = np.minimum(np.arange(rows), rows - np.arange(rows)).astype(np.float64)
    fx = np.minimum(np.arange(cols), cols - np.arange(cols)).astype(np.float64)
    return np.hypot(fy[:, None], fx[None, :])


def ideal_lowpass_mask(rows: int, cols: int, cutoff: float) -> np.ndarray:
    """Brick-wall low-pass: 1 inside radius `cutoff`."""
    return (_radius_grid(rows, cols) <= cutoff).astype(np.float64)


def ideal_highpass_mask(rows: int, cols: int, cutoff: float) -> np.ndarray:
    """Brick-wall high-pass (the edge-detection mask)."""
    return 1.0 - ideal_lowpass_mask(rows, cols, cutoff)


def gaussian_lowpass_mask(rows: int, cols: int, sigma: float) -> np.ndarray:
    """Gaussian low-pass: exp(-r^2 / (2*sigma^2))."""
    r = _radius_grid(rows, cols)
    return np.exp(-(r * r) / (2.0 * sigma * sigma))


def gaussian_highpass_mask(rows: int, cols: int, sigma: float) -> np.ndarray:
    return 1.0 - gaussian_lowpass_mask(rows, cols, sigma)


_MASKS = {("low", "ideal"): ideal_lowpass_mask, ("high", "ideal"): ideal_highpass_mask,
         ("low", "gaussian"): gaussian_lowpass_mask,
         ("high", "gaussian"): gaussian_highpass_mask}


@functools.lru_cache(maxsize=8)
def _device_mask(build, rows: int, cols: int, param: float, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(build(rows, cols, param)).to(device=device, dtype=dtype)


def apply_frequency_mask(img, mask, cfft=None, device="cuda"):
    """FFT2 -> mask -> IFFT2 over the last two axes; a real image gives a
    real image. `mask` is numpy or a tensor, [rows, cols] unshifted."""
    img = as_tensor(img, device)
    was_real = not img.is_complex()
    cdtype = complex_dtype_for(img.dtype)
    X = fft2(img.to(cdtype), FORWARD, cfft)
    M = as_tensor(mask, img.device).to(device=img.device, dtype=cdtype)
    y = ifft2(X * M, cfft)
    return y.real if was_real else y


def _filter(img, band: str, cutoff: float, kind: str, cfft, device):
    try:
        build = _MASKS[band, kind]
    except KeyError:
        raise ValueError(f"unknown filter kind {kind!r}") from None
    img = as_tensor(img, device)
    rows, cols = int(img.shape[-2]), int(img.shape[-1])
    mask = _device_mask(build, rows, cols, float(cutoff), complex_dtype_for(img.dtype),
                        img.device)
    return apply_frequency_mask(img, mask, cfft)


def lowpass_filter_image(img, cutoff: float, kind: str = "ideal", cfft=None,
                         device="cuda"):
    """Frequency-domain low-pass, `kind` "ideal" (radius `cutoff`) or
    "gaussian" (sigma `cutoff`)."""
    return _filter(img, "low", cutoff, kind, cfft, device)


def highpass_filter_image(img, cutoff: float, kind: str = "ideal", cfft=None,
                          device="cuda"):
    return _filter(img, "high", cutoff, kind, cfft, device)


def detect_edges(img, cutoff: float | None = None, cfft=None, device="cuda"):
    """Edge detection: the magnitude of the ideal high-pass, cutoff
    min(rows, cols)/8 by default."""
    img = as_tensor(img, device)
    if cutoff is None:
        cutoff = min(int(img.shape[-2]), int(img.shape[-1])) / 8.0
    return highpass_filter_image(img, cutoff, "ideal", cfft).abs()


def log_magnitude_spectrum(img, cfft=None, device="cuda"):
    """The shifted log-magnitude display spectrum log(1 + |FFT2|)."""
    img = as_tensor(img, device)
    X = fft2(img.to(complex_dtype_for(img.dtype)), FORWARD, cfft)
    return torch.log1p(fftshift(X, axes=(-2, -1)).abs())
