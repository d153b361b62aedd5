"""Radix-4 DIT FFT (counterpart of fftlab/algos/radix4.py): a base-4
digit-reversal gather, then log4(n) stages of 4-point butterflies, each
a contraction with the 4 x 4 DFT matrix after the stage's twiddles.
"""

from __future__ import annotations

import torch

from fftlab_torch.algos._common import index_table, inverse_scale, prepare, table
from fftlab_torch.core.bitrev import digit_reverse_indices
from fftlab_torch.core.precision import full_float32
from fftlab_torch.core.twiddle import dft_matrix_np, stage_twiddle_np
from fftlab_torch.core.types import FORWARD, is_power_of


def radix4_fft(x, direction=FORWARD):
    """In-order radix-4 DIT for n = 4^k."""
    x, n, direction = prepare(x, direction)
    if not is_power_of(n, 4):
        raise ValueError(f"radix-4 FFT requires n = 4^k, got n={n}")
    if n == 1:
        return x
    batch = x.shape[:-1]
    x = x.index_select(-1, index_table(digit_reverse_indices, n, 4, like=x))
    F4 = table(dft_matrix_np, 4, direction, like=x)
    m = 1
    while m < n:
        m *= 4
        q = m // 4
        # blocks of m, each four quarter-transforms of length q
        x = x.reshape(*batch, n // m, 4, q)
        t = x * table(stage_twiddle_np, 4, q, direction, like=x)  # W_m^{p*j}
        with full_float32():
            x = torch.matmul(F4, t)  # the 4-point butterfly over the quarter axis
    return inverse_scale(x.reshape(*batch, n), n, direction)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("radix4_fft", radix4_fft, device=demo_device())
