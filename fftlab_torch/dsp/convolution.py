"""Convolution: direct, FFT-based linear and circular, block-streaming
overlap-save and overlap-add, 2-D, and the split-plane linear
convolution (counterpart of fftlab/dsp/convolution.py).

Everything is batched over leading axes. A tensor stays on its device;
other input (numpy, lists) goes to `device`: the card by default, where
a missing card raises (`core.types.as_tensor`), and the CPU with
`device="cpu"`. The second operand goes to the first's device. The FFT
paths take any complex transform of the registry as `cfft`, the
tensor-op Stockham by default, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fftlab_torch.algos.split_stockham import stockham_fft_split_unscaled
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.types import (FORWARD, INVERSE, as_tensor, complex_dtype_for,
                                     next_power_of_two)
from fftlab_torch.plan.dispatch import spectral_filter_auto


def _cfft():
    from fftlab_torch.algos.stockham import stockham_fft

    return stockham_fft


def _pad_last(x: torch.Tensor, total: int) -> torch.Tensor:
    return F.pad(x, (0, total - int(x.shape[-1])))


def _operands(x, h, device):
    """(x, h, was_real, complex dtype): x placed by `as_tensor`, h on x's
    device, the complex dtype of their result type."""
    x = as_tensor(x, device)
    h = as_tensor(h, x.device)
    was_real = not (x.is_complex() or h.is_complex())
    return x, h, was_real, complex_dtype_for(torch.result_type(x, h))


def direct_convolution(x, h, device="cuda"):
    """O(n*m) time-domain convolution, the oracle: one `conv1d` of the
    flipped taps with nh - 1 zeros on each side, at full float32
    (`core.precision.full_float32`: cuDNN's TF32 off). A complex operand
    runs as four real products in the same call (the planes of x as a
    batch, the planes of h as two output channels), so no device's
    complex convolution and no conjugation enter."""
    x = as_tensor(x, device)
    h = as_tensor(h, x.device)
    dtype = torch.result_type(x, h)
    x, h = x.to(dtype), h.to(dtype)
    batch = tuple(x.shape[:-1])
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    xn = x.reshape(-1, 1, nx)
    hn = torch.flip(h, (-1,)).reshape(1, 1, nh)
    with full_float32():
        if not dtype.is_complex:
            y = F.conv1d(xn, hn, padding=nh - 1)[:, 0]
        else:
            rows = xn.shape[0]
            y = F.conv1d(torch.cat([xn.real, xn.imag]), torch.cat([hn.real, hn.imag]),
                         padding=nh - 1)
            re_re, re_im, im_re, im_im = y[:rows, 0], y[:rows, 1], y[rows:, 0], y[rows:, 1]
            y = torch.complex(re_re - im_im, re_im + im_re)
    return y.reshape(*batch, nx + nh - 1)


def fft_convolution(x, h, cfft=None, device="cuda"):
    """Linear convolution via FFT: zero-pad to next_pow2(nx+nh-1), two
    forward FFTs, pointwise multiply, inverse FFT, truncate."""
    if cfft is None:
        cfft = _cfft()
    x, h, was_real, cdtype = _operands(x, h, device)
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    m = next_power_of_two(nx + nh - 1)
    X = cfft(_pad_last(x.to(cdtype), m), FORWARD)
    H = cfft(_pad_last(h.to(cdtype), m), FORWARD)
    y = cfft(X * H, INVERSE)[..., : nx + nh - 1]
    return y.real if was_real else y


def circular_convolution(x, h, cfft=None, device="cuda"):
    """Circular convolution of equal-length signals."""
    if cfft is None:
        cfft = _cfft()
    x, h, was_real, cdtype = _operands(x, h, device)
    if x.shape[-1] != h.shape[-1]:
        raise ValueError("circular convolution requires equal lengths")
    y = cfft(cfft(x.to(cdtype), FORWARD) * cfft(h.to(cdtype), FORWARD), INVERSE)
    return y.real if was_real else y


def _default_block(nh: int) -> int:
    return max(next_power_of_two(4 * nh), 256)


def overlap_save(x, h, block: int | None = None, cfft=None, device="cuda"):
    """Linear convolution by overlap-save: hops of B = fft_size - (nh-1)
    samples, each prefixed by the previous nh - 1, all blocks framed as
    one strided view (`core.framing.frame_signal_strided`) and filtered
    as a batch: FFT -> H -> IFFT, the last B samples of each kept.
    Returns nx + nh - 1 samples, as `fft_convolution`."""
    if cfft is None:
        cfft = _cfft()
    x, h, was_real, cdtype = _operands(x, h, device)
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    fft_size = next_power_of_two(block if block is not None else _default_block(nh))
    hop = fft_size - (nh - 1)
    n_out = nx + nh - 1
    n_blocks = -(-n_out // hop)
    H = cfft(_pad_last(h.to(cdtype), fft_size), FORWARD)
    # left-pad with the (nh-1)-sample halo; the framer right-pads
    xp = F.pad(x.to(cdtype), (nh - 1, 0))
    frames = frame_signal_strided(xp, fft_size, hop, n_blocks)
    y = cfft(cfft(frames, FORWARD) * H, INVERSE)[..., nh - 1:]
    y = y.reshape(*y.shape[:-2], n_blocks * hop)[..., :n_out]
    return y.real if was_real else y


def overlap_add(x, h, block: int | None = None, cfft=None, device="cuda"):
    """Overlap-add block convolution: disjoint blocks of B samples, each
    zero-padded to fft_size >= B + nh - 1 and filtered as a batch. Block
    b lands at b*B, and the placement stride is the block size, so each
    filtered block is cut into k = ceil(fft_size/B) chunks of B and the
    sum runs over the k diagonal shifts: k whole-tensor adds, not one
    add per block."""
    if cfft is None:
        cfft = _cfft()
    x, h, was_real, cdtype = _operands(x, h, device)
    nx, nh = int(x.shape[-1]), int(h.shape[-1])
    if block is None:
        block = _default_block(nh)
    fft_size = next_power_of_two(block + nh - 1)
    n_blocks = -(-nx // block)
    n_out = nx + nh - 1
    batch = tuple(x.shape[:-1])
    H = cfft(_pad_last(h.to(cdtype), fft_size), FORWARD)
    frames = _pad_last(x.to(cdtype), n_blocks * block).reshape(*batch, n_blocks, block)
    y = cfft(cfft(_pad_last(frames, fft_size), FORWARD) * H, INVERSE)
    k = -(-fft_size // block)
    yk = _pad_last(y, k * block).reshape(*batch, n_blocks, k, block)
    out = y.new_zeros(*batch, n_blocks + k, block)
    for j in range(k):
        out[..., j:j + n_blocks, :] += yk[..., :, j, :]
    out = out.reshape(*batch, -1)[..., :n_out]
    return out.real if was_real else out


def convolve2d(img, kernel, cfft=None, device="cuda"):
    """2-D linear convolution via the 2-D FFT (`algos.fft2d.fft2`), each
    axis zero-padded to the power of two of its full output."""
    from fftlab_torch.algos.fft2d import fft2

    img, kernel, was_real, cdtype = _operands(img, kernel, device)
    r = int(img.shape[-2]) + int(kernel.shape[-2]) - 1
    c = int(img.shape[-1]) + int(kernel.shape[-1]) - 1
    rp, cp = next_power_of_two(r), next_power_of_two(c)

    def pad2(a):
        return F.pad(a.to(cdtype), (0, cp - int(a.shape[-1]), 0, rp - int(a.shape[-2])))

    Y = fft2(pad2(img), FORWARD, cfft) * fft2(pad2(kernel), FORWARD, cfft)
    y = fft2(Y, INVERSE, cfft)[..., :r, :c]
    return y.real if was_real else y


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
