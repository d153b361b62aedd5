"""Demo: the split routes by size, the two-pass kernels, and a split FFT
convolution. On the card the two-pass pair (`fft_split_large`) runs at
1 x 2^20 and the convolution's sandwich at m = 32768 (the two-pass
route with H in pass 2); `--device cpu` runs their plain versions, the
transform at 1 x 2^18."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fftlab_torch.cli import parse
from fftlab_torch.dsp.convolution import fft_convolution_split
from fftlab_torch.kernels.fourstep_vmem import fft_split_large
from fftlab_torch.plan.dispatch import select_split_impl
from fftlab_torch.plan.hardware import detect_hardware

CONV_N, CONV_TAPS = 1 << 14, 257


def two_pass_snr(xr: torch.Tensor, xi: torch.Tensor) -> float:
    """`fft_split_large` of the planes, in dB against numpy's float64 FFT."""
    yr, yi = fft_split_large(xr, xi)
    got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
    want = np.fft.fft(xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy())
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / np.sum(np.abs(got - want) ** 2)))


def convolution_error(x: torch.Tensor, h: np.ndarray) -> float:
    """Max abs error of `fft_convolution_split` of the real signal x with
    taps h against float64 np.convolve."""
    zr, _ = fft_convolution_split(x, torch.zeros_like(x), h)
    ref = np.convolve(x.double().cpu().numpy(), h.astype(np.float64))
    return float(np.max(np.abs(zr.double().cpu().numpy() - ref)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    args = parse(ap)

    print(f"hardware: {detect_hardware().summary()}\n")
    print("dispatch routes by size:")
    for e in (10, 13, 16, 18, 20, 22, 24, 26, 27):
        print(f"  n=2^{e:<3} -> {select_split_impl(1 << e)}")

    on_card = args.device.type == "cuda"
    n = 1 << 20 if on_card else 1 << 18
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(args.device)
    xi = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(args.device)

    t0 = time.perf_counter()
    snr = two_pass_snr(xr, xi)
    print(f"\ntwo-pass kernel, n=2^{n.bit_length()-1}: {snr:.1f} dB vs float64 oracle "
          f"({time.perf_counter()-t0:.1f}s incl. build, "
          f"{'card' if on_card else 'plain version on the CPU'})")

    h = rng.standard_normal(CONV_TAPS).astype(np.float32) / CONV_TAPS
    err = convolution_error(xr[0][:CONV_N], h)
    print(f"fft_convolution_split 16K x {CONV_TAPS} taps: max err {err:.2e}")


if __name__ == "__main__":
    main()
