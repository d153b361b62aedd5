"""Mixed-radix Cooley-Tukey FFT by prime factorization (counterpart of
fftlab/algos/mixed_radix.py).

Each level on a [..., n] tensor, n = p*m with p the smallest prime:
reshape to [..., p, m], the codelet DFT over the p axis, the twiddle
exp(2*pi*i*dir*k1*j2/n), recurse over the m axis, transpose to
[..., m, p] and flatten (X[k2*p + k1]). A prime above 64 goes to
Bluestein.
"""

from __future__ import annotations

import functools

from fftlab_torch.algos._common import inverse_scale, prepare, table
from fftlab_torch.algos.codelets import apply_codelet
from fftlab_torch.core.twiddle import stage_twiddle_np
from fftlab_torch.core.types import FORWARD, Direction

# Primes above this use Bluestein rather than an O(p^2) codelet matmul.
_LARGE_PRIME = 64


@functools.lru_cache(maxsize=None)
def factorize(n: int) -> tuple[int, ...]:
    """Trial-division prime factorization, smallest first."""
    if n < 1:
        raise ValueError(f"cannot factorize n={n}")
    factors = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1 if p == 2 else 2
    if m > 1:
        factors.append(m)
    return tuple(factors)


def is_prime(n: int) -> bool:
    return n > 1 and factorize(n) == (n,)


def is_highly_composite(n: int) -> bool:
    """Only factors 2, 3, 5, 7 and at least three of them."""
    f = factorize(n)
    return len(f) >= 3 and all(p in (2, 3, 5, 7) for p in f)


def _mixed_radix_unscaled(x, n: int, direction: Direction):
    if n == 1:
        return x
    p = factorize(n)[0]
    if p == n and p > _LARGE_PRIME:
        # a large prime: chirp-z, unscaled (the caller applies 1/n once)
        from fftlab_torch.algos.bluestein import bluestein_fft

        y = bluestein_fft(x, direction)
        return y * float(n) if direction == Direction.INVERSE else y
    if p == n:
        return apply_codelet(x[..., :, None], p, direction)[..., :, 0]
    m = n // p
    batch = x.shape[:-1]
    y = apply_codelet(x.reshape(*batch, p, m), p, direction)  # DFT over the p axis
    y = y * table(stage_twiddle_np, p, m, direction, like=x)  # [p, m] twiddles
    y = _mixed_radix_unscaled(y, m, direction)  # recurse over the last axis
    return y.transpose(-1, -2).reshape(*batch, n)  # X[k2*p + k1]


def mixed_radix_fft(x, direction=FORWARD):
    """General-size FFT by prime factorization (any n >= 1)."""
    x, n, direction = prepare(x, direction)
    return inverse_scale(_mixed_radix_unscaled(x, n, direction), n, direction)


def mixed_radix_fft_recursive(x, direction=FORWARD):
    """Alias of `mixed_radix_fft` under the reference's recursive entry
    point's name (fftlab/algos/mixed_radix.py:96)."""
    return mixed_radix_fft(x, direction)


if __name__ == "__main__":
    from fftlab_torch.algos._common import demo_device, run_module_demo

    run_module_demo("mixed_radix_fft", mixed_radix_fft, device=demo_device())
