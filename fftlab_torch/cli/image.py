"""2-D FFT image demo: test patterns and their shifted log-magnitude
spectra, a Gaussian blur and high-pass edge detection, as ASCII
images."""

from __future__ import annotations

import argparse

from fftlab_torch.cli import parse
from fftlab_torch.core.types import to_host
from fftlab_torch.dsp.image import (detect_edges, generate_2d_gaussian, generate_2d_rect,
                                    generate_2d_sinusoid, log_magnitude_spectrum,
                                    lowpass_filter_image)
from fftlab_torch.utils.plotting import ascii_image


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=64)
    args = parse(ap)
    dev = args.device

    r = c = args.size
    for name, img in [
        ("2D sinusoid (4,2 cycles)", generate_2d_sinusoid(r, c, 4, 2)),
        ("Gaussian blob", generate_2d_gaussian(r, c, r / 8)),
        ("rectangle", generate_2d_rect(r, c, r // 4, c // 4)),
    ]:
        print(f"\n=== {name} ===")
        print(ascii_image(img, 48, 16))
        print("log-magnitude spectrum (shifted):")
        print(ascii_image(to_host(log_magnitude_spectrum(img, device=dev)), 48, 16))

    rect = generate_2d_rect(r, c, r // 3, c // 3)
    print("\nGaussian low-pass of rectangle (blur):")
    print(ascii_image(to_host(lowpass_filter_image(rect, r / 10, "gaussian", device=dev)),
                      48, 16))
    print("\nedge detection (high-pass magnitude):")
    print(ascii_image(to_host(detect_edges(rect, device=dev)), 48, 16))


if __name__ == "__main__":
    main()
