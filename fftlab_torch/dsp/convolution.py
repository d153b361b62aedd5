"""Linear convolution on split planes (counterpart of
fftlab/dsp/convolution.py:194-226). The other convolutions of the JAX
module (direct, complex FFT, circular, overlap-save, overlap-add, 2-D)
are not ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fftlab_torch.algos.split_stockham import stockham_fft_split_unscaled
from fftlab_torch.core.types import FORWARD, next_power_of_two
from fftlab_torch.plan.dispatch import spectral_filter_auto


def fft_convolution_split(xr, xi, h, device="cuda"):
    """Linear convolution of split planes [..., nx] with real taps h [nh]:
    zero-pad to the power of two m >= nx + nh - 1, FFT -> H -> IFFT
    through `spectral_filter_auto`, truncate. Returns (yr, yi) of length
    nx + nh - 1. Inputs are taken as float32, as the JAX function takes
    them; H is the float32 FFT of the padded taps on the planes' device.

    Tensor planes stay on their device. Other planes (numpy, lists) go to
    `device`: the card by default, as the JAX function puts them on its
    default device; without a CUDA device the default raises rather than
    falling back to the CPU, and `device="cpu"` runs there."""
    if isinstance(xr, torch.Tensor):
        dev = xr.device
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "fft_convolution_split runs on the card by default and no CUDA "
                'device is available; pass device="cpu" to run it on the CPU')
    xr = torch.as_tensor(xr, dtype=torch.float32, device=dev)
    xi = torch.as_tensor(xi, dtype=torch.float32, device=dev)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    nx, nh = int(xr.shape[-1]), int(h.shape[-1])
    out_len = nx + nh - 1
    m = next_power_of_two(out_len)
    hp = F.pad(h, (0, m - nh))
    Hr, Hi = stockham_fft_split_unscaled(hp, torch.zeros_like(hp), FORWARD)
    yr, yi = spectral_filter_auto(F.pad(xr, (0, m - nx)), F.pad(xi, (0, m - nx)),
                                  Hr, Hi)
    return yr[..., :out_len], yi[..., :out_len]
