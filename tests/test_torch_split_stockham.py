"""fftlab_torch.algos.split_stockham (the `einsum` route) against
fftlab.algos.split_stockham on the same float32 inputs.

Gates: port vs the float64 numpy oracle >= 120 dB SNR; port vs JAX
>= 110 dB. Both sides compute in float32 with different summation
orders (torch einsum vs XLA), so they agree to f32 roundoff, not bit for
bit; the gates are the JAX suite's own (tests/test_resident_vmem.py:37,
tests/test_kernels.py:39)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab.algos import split_stockham as jx
from fftlab_torch.algos import split_stockham as pt

SIZES = [64, 1000, 4096, 1 << 15]


@pytest.mark.parametrize("n", SIZES)
def test_forward_matches_jax(n):
    xr, xi = planes(n, (2, 3, n))
    got = cplx(*pt.fft_split(tt(xr), tt(xi)))
    want = cplx(*jx.fft_split(jnp.asarray(xr), jnp.asarray(xi)))
    assert got.shape == (2, 3, n)
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, -1)) >= 120.0


@pytest.mark.parametrize("n", SIZES)
def test_inverse_matches_jax(n):
    xr, xi = planes(n + 1, (2, 3, n))
    got = cplx(*pt.ifft_split(tt(xr), tt(xi)))
    want = cplx(*jx.ifft_split(jnp.asarray(xr), jnp.asarray(xi)))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, 1, 1.0 / n)) >= 120.0


@pytest.mark.parametrize("n", [64, 4096])
def test_unscaled_inverse(n):
    xr, xi = planes(3, (2, n))
    got = cplx(*pt.stockham_fft_split_unscaled(tt(xr), tt(xi), 1))
    want = cplx(*jx.stockham_fft_split_unscaled(jnp.asarray(xr),
                                                 jnp.asarray(xi), 1))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, oracle(xr, xi, 1)) >= 120.0


@pytest.mark.parametrize("leaf", [16, 64, 1024])
def test_leaf_matches_jax(leaf):
    n = 4096
    xr, xi = planes(leaf, (2, n))
    got = cplx(*pt.fft_split(tt(xr), tt(xi), -1, leaf))
    want = cplx(*jx.fft_split(jnp.asarray(xr), jnp.asarray(xi), -1, leaf))
    assert snr_db(got, want) >= 110.0


def test_roundtrip():
    xr, xi = planes(9, (4, 6000))
    yr, yi = pt.fft_split(tt(xr), tt(xi))
    br, bi = pt.ifft_split(yr, yi)
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= 120.0


def test_length_one_is_identity():
    xr, xi = planes(1, (3, 1))
    yr, yi = pt.fft_split(tt(xr), tt(xi))
    assert torch.equal(yr, tt(xr)) and torch.equal(yi, tt(xi))


@pytest.mark.parametrize("n", [257, 2 * 131, 1009])
def test_bluestein_sizes_not_ported(n):
    """Sizes with a prime factor above the leaf go to Bluestein, as in the
    JAX package (split_stockham.py:137-142); they once raised here.
    Gate: the JAX suite's float32 Bluestein gate, 95 dB
    (tests/test_split.py:272)."""
    xr, xi = planes(n, (1, n))
    got = cplx(*pt.fft_split(tt(xr), tt(xi)))
    want = cplx(*jx.fft_split(jnp.asarray(xr), jnp.asarray(xi)))
    assert snr_db(got, oracle(xr, xi, -1)) >= 95.0
    assert snr_db(got, want) >= 95.0


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        pt.stockham_fft_split_unscaled(torch.zeros(2, 64), torch.zeros(3, 64))
