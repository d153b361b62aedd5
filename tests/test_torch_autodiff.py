"""fftlab_torch's differentiable kernel transforms (kernels/_ad.py) on
the CPU against `jax.grad` / `jax.vjp` of the JAX package's `_ad`
functions (their kernels in interpret mode) on the same losses as
tests/test_autodiff.py: the spectrum energy sum(|FFT(x)|^2), whose
gradient is 2*n*x by Parseval, and a random cotangent. One size per
kernel window: n = 8192 (`pallas_fft_split_ad`), 2^15
(`fft_split_large_ad`) and 2^21 (`fft_split_huge_ad`).

Gates: >= 110 dB SNR between the two packages' gradients (float32 on
both sides, different summation orders) and against the float64
closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.kernels.fft_vmem as jx_rows
import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.threestep_vmem as jx_ts
from _torch_parity import planes, snr_db, tt
from fftlab_torch.kernels import fft_vmem, fourstep_vmem, threestep_vmem

KERNELS = {
    "rows": (fft_vmem.pallas_fft_split_ad, jx_rows.pallas_fft_split_ad, 8192),
    "two_pass": (fourstep_vmem.fft_split_large_ad, jx_fs.fft_split_large_ad, 1 << 15),
    "three_pass": (threestep_vmem.fft_split_huge_ad, jx_ts.fft_split_huge_ad, 1 << 21),
}


def _real_grad(g) -> np.ndarray:
    return np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g, np.float64)


@pytest.mark.parametrize("name", list(KERNELS))
def test_energy_grad_matches_jax(name):
    ours, theirs, n = KERNELS[name]
    x = planes(n, (n,))[0]

    xt = tt(x).requires_grad_(True)
    yr, yi = ours(xt, torch.zeros_like(xt))
    (g,) = torch.autograd.grad((yr * yr + yi * yi).sum(), xt)

    def energy(a):
        br, bi = theirs(a, jnp.zeros_like(a), -1, True)
        return jnp.sum(br * br + bi * bi)

    want = jax.grad(energy)(jnp.asarray(x))
    assert snr_db(_real_grad(g), _real_grad(want)) >= 110.0
    assert snr_db(_real_grad(g), 2 * n * x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("direction", [-1, 1], ids=["fwd", "inv"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_vjp_matches_jax(name, direction):
    ours, theirs, n = KERNELS[name]
    xr, xi = planes(n + 1, (2, n))
    cr, ci = planes(n + 2, (2, n))

    ar, ai = tt(xr).requires_grad_(True), tt(xi).requires_grad_(True)
    yr, yi = ours(ar, ai, direction)
    gr, gi = torch.autograd.grad((yr * tt(cr) + yi * tt(ci)).sum(), (ar, ai))

    _, vjp = jax.vjp(lambda a, b: theirs(a, b, direction, True),
                     jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = vjp((jnp.asarray(cr), jnp.asarray(ci)))
    got = _real_grad(gr) + 1j * _real_grad(gi)
    assert snr_db(got, _real_grad(wr) + 1j * _real_grad(wi)) >= 110.0
    # the adjoint in float64: conj(F) c, unscaled for the forward and
    # times 1/n for the inverse
    c = cr + 1j * ci.astype(np.float64)
    want = np.fft.ifft(c) * n if direction == -1 else np.fft.fft(c) / n
    assert snr_db(got, want) >= 110.0


def test_grad_flows_through_a_chain():
    """The adjoints compose: d/dx of |IFFT(FFT(x) * h)|^2 on the two-pass
    kernel equals the same loss on the einsum route's autograd."""
    n = 1 << 15
    xr, xi = planes(5, (n,))
    h = torch.from_numpy(np.random.default_rng(6).standard_normal(n).astype(np.float32))

    def loss(fft, a):
        yr, yi = fft(a, torch.zeros_like(a), -1)
        br, bi = fft(yr * h, yi * h, 1)
        return (br * br + bi * bi).sum()

    a = tt(xr).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(fourstep_vmem.fft_split_large_ad, a), a)
    from fftlab_torch.algos.split_stockham import fft_split

    b = tt(xr).requires_grad_(True)
    (want,) = torch.autograd.grad(loss(lambda p, q, d: fft_split(p, q, d), b), b)
    assert snr_db(_real_grad(g), _real_grad(want)) >= 110.0
