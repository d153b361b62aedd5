"""The comparison that decides `correct`: each row's SNR against its
float64 reference, 10 log10(sum |ref|^2 / sum |out - ref|^2) (the
arithmetic of fftlab_torch/utils/metrics.snr_db, per row, in float64 on
the tensors' device)."""

from __future__ import annotations

import math

import torch

# dB given to a row that matches its reference exactly.
EXACT_DB = 400.0


def row_snr_db(yr: torch.Tensor, yi: torch.Tensor, want: torch.Tensor) -> list:
    """SNR in dB of each row of the float32 planes (yr, yi) against the
    complex128 rows `want`; -inf for a row of another shape, NaN for a row
    with a NaN."""
    if tuple(yr.shape) != tuple(want.shape) or tuple(yi.shape) != tuple(want.shape):
        return [-math.inf] * max(1, want.shape[0])
    got = torch.complex(yr.double(), yi.double())
    p_sig = want.abs().square().sum(dim=-1)
    p_noise = (got - want).abs().square().sum(dim=-1)
    return [_db(s, e) for s, e in zip(p_sig.tolist(), p_noise.tolist())]


def _db(p_sig: float, p_noise: float) -> float:
    if math.isnan(p_noise):
        return math.nan
    if p_noise == 0:
        return EXACT_DB
    if math.isinf(p_noise) or p_sig == 0:
        return -math.inf
    return 10.0 * math.log10(p_sig / p_noise)
