"""Reduced-precision FFTs (counterpart of fftlab/algos/lowprec.py): the
split Stockham route's contractions at a lower float32 matmul tier, and
what each tier costs in SNR, with the Q15 fixed-point FFT
(`fftlab_torch.native.q15`) at the low end.

Modes (`fft_split(..., precision=)` on the Stockham stages; PyTorch's
tiers, `core.precision.matmul_precision`), with the SNR against float64
and the time of one call at 16 x 2^20 in two runs on an NVIDIA H100
80GB HBM3 at 700 W (chip_smoke.py phase 4g):

  mode     tier        on the H100                           SNR       ms
  'f32'    "highest"   float32 outside the tensor cores      129.7 dB  8.03, 12.68
  'f32x3'  "high"      TF32 tensor cores                      67.5 dB  8.00, 11.80
  'bf16'   "medium"    TF32 as well: PyTorch has no          67.5 dB  7.24, 14.28
                       bfloat16 kernel for a float32 GEMM
                       on CUDA (oneDNN runs bfloat16 on a
                       CPU with bfloat16 units: about 50 dB)

The reduced tiers save little time on the card: the route's time is
not in its matmuls. The native
Q15 FFT reads 32.4 dB at 4096 points (`snr_vs_oracle`).

The reduced modes are explicit opt-ins: every default path of the port
runs at full float32 (`core.precision.full_float32`). A hand-built
3xTF32 split, which would come near float32 on the tensor cores, is an
algorithm the JAX package lacks and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

from fftlab_torch.algos.split_stockham import DEFAULT_LEAF_SPLIT, fft_split
from fftlab_torch.core.types import FORWARD, require_device

PRECISIONS = {"f32": "highest", "f32x3": "high", "bf16": "medium"}


def fft_split_lowprec(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD,
                      mode: str = "f32", leaf: int = DEFAULT_LEAF_SPLIT):
    """Split-complex FFT with the Stockham stages at the matmul tier of
    `mode` (one of `PRECISIONS`); 'f32' is full float32."""
    if mode not in PRECISIONS:
        raise ValueError(f"mode must be one of {sorted(PRECISIONS)}")
    return fft_split(xr, xi, direction, leaf, precision=PRECISIONS[mode])


def _snr(got: np.ndarray, want: np.ndarray) -> float:
    err = np.sum(np.abs(got - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def snr_vs_oracle(n: int = 4096, batch: int = 2, seed: int = 0,
                  modes=("f32", "f32x3", "bf16"), device="cuda") -> dict:
    """Each mode's SNR in dB against the float64 numpy FFT, on `device`
    (the card unless the caller passes "cpu"): {mode: snr_db}, with a
    'q15' row, the native Q15 FFT of the first row scaled into (-1, 1),
    when the native library builds."""
    from fftlab_torch.native.lib import native_available

    dev = require_device(device)
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    out = {}
    for mode in modes:
        yr, yi = fft_split_lowprec(torch.from_numpy(xr).to(dev),
                                   torch.from_numpy(xi).to(dev), mode=mode)
        got = (yr.cpu().numpy().astype(np.float64)
               + 1j * yi.cpu().numpy().astype(np.float64))
        out[mode] = _snr(got, want)
    if native_available():
        from fftlab_torch.native.q15 import q15_fft_float

        z = (xr[0] + 1j * xi[0]) / (4 * np.abs(xr[0] + 1j * xi[0]).max())
        out["q15"] = _snr(q15_fft_float(z), np.fft.fft(z))
    return out
