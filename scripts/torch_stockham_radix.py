"""Sweep the stage radix cap of fftlab_torch's complex Stockham on a CUDA card.

For each cap (1024, the JAX package's leaf; 128; 64, fftlab_torch's
`STAGE_RADIX`), runs the complex64 transform of 16 x 2^20 random samples
through the stages that cap gives and prints the forward SNR against a
complex128 `torch.fft.fft`, the round trip's SNR, and the ms per call
(`fftlab_torch.bench.timing.time_ms`), beside the card's name and power
limit. Needs a card:

    python3 scripts/torch_stockham_radix.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fftlab_torch.algos import stockham  # noqa: E402
from fftlab_torch.bench.timing import time_ms  # noqa: E402
from fftlab_torch.core.types import FORWARD, INVERSE  # noqa: E402

CAPS = (1024, 128, 64)
SHAPE = (16, 1 << 20)


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    err = (got - want).abs().square().sum().clamp_min(1e-300)
    return float(10 * torch.log10(want.abs().square().sum() / err))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this sweep runs on the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, n = SHAPE
    x = torch.complex(torch.randn(B, n, generator=gen, device="cuda"),
                      torch.randn(B, n, generator=gen, device="cuda"))
    want = torch.fft.fft(x.to(torch.complex128))
    for cap in CAPS:
        factors = stockham.stage_factors(n, cap=cap)
        y = stockham._run_stages(x, FORWARD, factors)
        back = stockham._run_stages(y, INVERSE, factors) / n
        ms = time_ms(lambda: stockham._run_stages(x, FORWARD, factors), "cuda",
                     iters=25, inner=10, warmup=10)
        print(f"stockham radix cap {cap} {factors} {B} x 2^20: {snr_db(y, want):.1f} dB "
              f"forward, {snr_db(back, x):.1f} dB round trip, {ms:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
