"""Minimal self-contained 8-point FFT on the card (counterpart of
examples/minimal.py): the smallest fftlab_torch program, no planner, no
DSP layer.

Run: python -m fftlab_torch.examples.minimal
"""

import numpy as np

import fftlab_torch

N = 8


def main(device="cuda") -> None:
    """The FFT of a unit impulse at t=1, printed and checked against
    W_8^k, on `device` (the card by default; raises without one)."""
    from fftlab_torch.core.types import as_tensor

    x = np.zeros(N, dtype=np.complex64)
    x[1] = 1.0  # unit impulse at t=1 -> spectrum = exp(-2*pi*i*k/8)

    X = fftlab_torch.fft(as_tensor(x, device)).cpu().numpy()
    print(f"{'k':>2} {'re':>9} {'im':>9} {'|X|':>7}")
    for k in range(N):
        print(f"{k:>2} {X[k].real:>9.4f} {X[k].imag:>9.4f} {abs(X[k]):>7.4f}")

    want = np.exp(-2j * np.pi * np.arange(N) / N)
    if not np.allclose(X, want, atol=1e-6):
        raise SystemExit("self-test failed")
    print("self-test passed: X[k] = W_8^k")


if __name__ == "__main__":
    main()
