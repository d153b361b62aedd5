"""Pedagogical iterative FFT with an execution-plan explainer
(counterpart of fftlab/algos/iterative.py).

The same math as radix-2 DIT in the classic in-place formulation: the
tensor keeps one [..., n] layout for every stage, and each stage finds
its butterfly partners (i XOR m/2) and twiddle exponents (j * n/m) from
the stage counter. The JAX package rolls the stages into one
`lax.fori_loop` body; here the same body runs in a Python loop over the
stages.
"""

from __future__ import annotations

import torch

from fftlab_torch.algos._common import index_table, inverse_scale, prepare, table
from fftlab_torch.core.bitrev import bit_reverse_indices
from fftlab_torch.core.twiddle import twiddle_np
from fftlab_torch.core.types import FORWARD, is_power_of_two, log2_int


def iterative_fft(x, direction=FORWARD):
    """In-place-formulation radix-2 DIT, one stage body for all stages."""
    x, n, direction = prepare(x, direction)
    if not is_power_of_two(n):
        raise ValueError(f"iterative FFT requires power-of-two size, got n={n}")
    if n == 1:
        return x
    log2n = log2_int(n)
    x = x.index_select(-1, index_table(bit_reverse_indices, n, like=x))
    # W_n^k for k < n/2; stage s uses W_n^(j * n/m)
    wn = table(twiddle_np, n, direction, like=x)[: max(n // 2, 1)]
    i = torch.arange(n, device=x.device)
    for s in range(log2n):
        half = 1 << s  # m/2 for m = 2^(s+1)
        j = i & (half - 1)  # index within the half-block
        upper = (i & half) != 0  # odd-half element?
        partner = i ^ half
        w = wn[j << (log2n - 1 - s)]  # exponent j * (n/m) < n/2
        xp = x.index_select(-1, partner)
        u = torch.where(upper, xp, x)  # even-half value
        v = torch.where(upper, x, xp)  # odd-half value
        t = w * v
        x = torch.where(upper, u - t, u + t)
    return inverse_scale(x, n, direction)


def explain(n: int) -> str:
    """Describe the stage-by-stage plan of an n-point transform."""
    if not is_power_of_two(n):
        raise ValueError("explain() requires a power-of-two size")
    lines = [
        f"iterative radix-2 DIT plan for n={n} (log2(n)={log2_int(n)} stages)",
        f"  step 0: bit-reversal permutation as ONE gather of {n} indices",
        f"          (table: {bit_reverse_indices(min(n, 16)).tolist()}{'...' if n > 16 else ''})",
    ]
    for s in range(1, log2_int(n) + 1):
        m = 1 << s
        lines.append(
            f"  stage {s}: {n // m} blocks x {m // 2} butterflies, span m={m}; "
            f"one pass over the [{n}] layout, {m // 2} twiddles W_{m}^j"
        )
    lines.append(
        "  in PyTorch: one stage body for every stage (partner = i XOR m/2,\n"
        "  twiddle exponent = j*n/m: index tensors over a fixed [n] layout);\n"
        "  each stage is a gather, three selects and a multiply.")
    return "\n".join(lines)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    print(explain(16))
    run_module_demo("iterative_fft", iterative_fft, device=demo_device())
