"""Convolution demo: direct vs FFT vs streaming overlap-save/overlap-add,
and circular convolution, with agreement checks."""

from __future__ import annotations

import argparse

import numpy as np

from fftlab_torch.cli import parse
from fftlab_torch.core.types import to_host
from fftlab_torch.dsp.convolution import (circular_convolution, direct_convolution,
                                          fft_convolution, overlap_add, overlap_save)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--nh", type=int, default=101)
    args = parse(ap)
    dev = args.device

    rng = np.random.default_rng(0)
    x = rng.standard_normal(args.nx)
    h = rng.standard_normal(args.nh)

    # float64 numpy in, so the port computes in float64; the bound is
    # that working precision's
    ref = to_host(direct_convolution(x, h, device=dev))
    tol = 1e-8 if ref.dtype == np.float64 else 1e-3
    print(f"linear convolution of {args.nx} x {args.nh} "
          f"-> {ref.shape[-1]} samples")
    for name, fn in [("fft_convolution", fft_convolution),
                     ("overlap_save", overlap_save),
                     ("overlap_add", overlap_add)]:
        got = to_host(fn(x, h, device=dev))
        err = np.max(np.abs(got - ref))
        print(f"  {name:<16} max err vs direct: {err:.2e} "
              f"{'OK' if err < tol else 'FAIL'}")

    xc = rng.standard_normal(1024)
    hc = rng.standard_normal(1024)
    cc = to_host(circular_convolution(xc, hc, device=dev))
    want = np.real(np.fft.ifft(np.fft.fft(xc) * np.fft.fft(hc)))
    print(f"  circular (1024)   max err vs numpy:  "
          f"{np.max(np.abs(cc - want)):.2e}")


if __name__ == "__main__":
    main()
