"""fftlab_torch's complex-dtype algorithms against fftlab's: the registry,
every (algorithm, n) of tests/test_properties.py's CASES, the C golden
files, the real and 2-D transforms and the split-plane helpers.

Inputs are made with numpy from a seed and cast explicitly (jax x64 is
on, tests/conftest.py); both packages get the same values. Gates: port
vs JAX within 1e-10 of the largest output at complex128 and 1e-5 at
complex64 (tests/test_properties.py's TOL_F64 and TOL_F32); `pallas_vmem`
computes in float32 in both packages and takes 1e-5 at either dtype, its
JAX kernel in interpret mode (n = 1024, its only CASES size). For the
CASES the JAX side runs once per (algorithm, n), jitted, on the
complex64 input's values at complex128, and both of the port's dtypes
are held to that result: the complex64 port within 1e-5 of the JAX
function's float64-accurate answer, a stricter gate than JAX's own
complex64 result would be."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab
import fftlab.algos as jx_algos
import fftlab.algos.dft as jx_dft
import fftlab.algos.fft2d as jx_fft2d
import fftlab.algos.iterative as jx_iterative
import fftlab.algos.mixed_radix as jx_mixed
import fftlab.algos.real_fft as jx_real
import fftlab.algos.recursive as jx_recursive
import fftlab.algos.split_stockham as jx_split
import fftlab.core.types as jx_types
import fftlab.dist.four_step as jx_four_step
import fftlab_torch
from _torch_parity import tt
from fftlab_torch import algos
from fftlab_torch.algos import (bluestein, dft, fft2d, iterative, mixed_radix, real_fft,
                                recursive, split_stockham, stockham)
from fftlab_torch.core import types
from fftlab_torch.dist import four_step
from test_c_parity import _load
from test_properties import CASES, F32_ONLY, TOL_F32, TOL_F64

REG = algos.build_registry()
JX_REG = jx_algos.build_registry()


def cx(seed: int, shape, dtype=np.complex128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def port(fn, *args, **kw):
    """Call a port function on CPU tensors made from numpy arrays; numpy out."""
    args = [tt(a) if isinstance(a, np.ndarray) else a for a in args]
    out = fn(*args, **kw)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def test_registry_names_and_order():
    assert list(REG) == list(JX_REG)
    assert len(REG) == 13


@pytest.mark.parametrize("name", list(JX_REG))
def test_registry_supports(name):
    ours, theirs = REG[name].supports, JX_REG[name].supports
    assert [n for n in range(1, 4101) if ours(n)] == [n for n in range(1, 4101) if theirs(n)]


@functools.lru_cache(maxsize=None)
def _jax_both(name: str, n: int):
    """The JAX algorithm's forward and inverse of the CASES input."""
    fn = JX_REG[name].fn
    both = jax.jit(lambda v: (fn(v, -1), fn(v, 1)))
    return tuple(np.asarray(y) for y in both(jnp.asarray(cx(n, (3, n), np.complex64),
                                                         jnp.complex128)))


def _parity(name, n, dtype, tol):
    x = cx(n, (3, n), np.complex64).astype(dtype)
    for direction, want in zip((-1, 1), _jax_both(name, n)):
        got = port(REG[name].fn, x, direction)
        assert got.shape == want.shape
        assert rel_err(got, want) <= tol, (name, n, direction)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_registry_matches_jax_complex128(name, n):
    _parity(name, n, np.complex128, TOL_F32 if name in F32_ONLY else TOL_F64)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_registry_matches_jax_complex64(name, n):
    _parity(name, n, np.complex64, TOL_F32)


GOLDEN = [  # (input, expected output file, atol): tests/test_c_parity.py's
    (np.sin(2 * np.pi * 50.0 * np.arange(1024) / 1024).astype(np.complex128),
     "golden_sine50_1024.txt", 1e-9),
    (_load("golden_lcg_input_256.txt"), "golden_lcg_fft_256.txt", 1e-9),
    (np.where(np.arange(97) % 7 == 0, 1.0, 0.0).astype(np.complex128),
     "golden_bluestein_97.txt", 1e-8),
]


@pytest.mark.parametrize("case", range(len(GOLDEN)),
                         ids=[g[1].removesuffix(".txt") for g in GOLDEN])
def test_c_golden_through_registry(case):
    """Every registry algorithm that takes the golden size (the
    educational ones within their test caps) against the compiled C
    reference's output, and the public `fft`."""
    x, name, atol = GOLDEN[case]
    want = _load(name)
    n = len(x)
    for algo, spec in REG.items():
        if not spec.supports(n) or (algo == "recursive" and n > 256):
            continue
        got = port(spec.fn, x)
        tol = 1e-5 * np.max(np.abs(want)) if algo in F32_ONLY else atol
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=algo)
    np.testing.assert_allclose(port(fftlab_torch.fft, x), want, rtol=0, atol=atol)


@pytest.mark.parametrize("k", [0, 1, 5, [0, 3, 63]])
@pytest.mark.parametrize("direction", [-1, 1])
def test_goertzel_and_dft_bin(k, direction):
    x = cx(7, (2, 64))
    for kk in np.atleast_1d(k):
        want = np.asarray(jx_dft.goertzel(jnp.asarray(x), int(kk), direction))
        got_bin = port(dft.dft_bin, x, int(kk), direction)
        assert rel_err(got_bin, np.asarray(jx_dft.dft_bin(jnp.asarray(x), int(kk),
                                                          direction))) <= 1e-12
        assert rel_err(port(dft.goertzel, x, int(kk), direction), want) <= 1e-10
    got = port(dft.goertzel, x, k, direction)
    if np.ndim(k):  # one loop over the samples for all the bins
        want = np.stack([np.asarray(jx_dft.goertzel(jnp.asarray(x), kk, direction))
                         for kk in k], axis=-1)
        assert got.shape == (2, len(k)) and rel_err(got, want) <= 1e-10


@pytest.mark.parametrize("n", [1, 2, 7, 16, 100])
def test_optimized_dft_real_input(n):
    x = np.random.default_rng(n).standard_normal((2, n))
    got = port(dft.optimized_dft, x)
    assert rel_err(got, np.asarray(jx_dft.optimized_dft(jnp.asarray(x)))) <= 1e-12
    assert rel_err(got, np.fft.fft(x)) <= 1e-12


def test_mixed_radix_helpers():
    for n in range(1, 3000):
        assert mixed_radix.factorize(n) == jx_mixed.factorize(n)
        assert mixed_radix.is_prime(n) == jx_mixed.is_prime(n)
        assert mixed_radix.is_highly_composite(n) == jx_mixed.is_highly_composite(n)


@pytest.mark.parametrize("n,leaf", [(4096, 64), (1 << 20, 1024), (3000, 16), (2 * 67, 1024)])
def test_stockham_leaf_and_plan(n, leaf):
    import fftlab.algos.stockham as jx_stockham

    assert stockham.plan_factors(n, leaf) == jx_stockham.plan_factors(n, leaf)
    if n <= 4096:
        x = cx(n, (2, n))
        got = port(stockham.stockham_fft, x, -1, leaf)
        assert rel_err(got, np.asarray(jx_stockham.stockham_fft(jnp.asarray(x), -1, leaf))) <= 1e-10


def test_bluestein_with_stockham_pow2():
    import fftlab.algos.bluestein as jx_bluestein
    import fftlab.algos.stockham as jx_stockham

    x = cx(11, (2, 1009))
    got = port(bluestein.bluestein_fft, x, 1, stockham.stockham_fft_unscaled)
    want = jx_bluestein.bluestein_fft(jnp.asarray(x), 1, jx_stockham.stockham_fft_unscaled)
    assert rel_err(got, np.asarray(want)) <= 1e-10


@pytest.mark.parametrize("n,n1", [(4096, None), (3000, None), (4096, 16), (360, 8)])
def test_four_step(n, n1):
    assert four_step.split_n(n, n1) == jx_four_step.split_n(n, n1)
    x = cx(n, (2, n))
    for direction in (-1, 1):
        got = port(four_step.four_step_fft, x, direction, n1)
        want = np.asarray(jx_four_step.four_step_fft(jnp.asarray(x), direction, n1))
        assert rel_err(got, want) <= 1e-10
    with pytest.raises(ValueError):
        four_step.split_n(100, 7)


def test_explain_and_recursion_tree(capsys):
    ours = iterative.explain(64).splitlines()
    theirs = jx_iterative.explain(64).splitlines()
    assert ours[0] == theirs[0]
    # the stages: blocks, butterflies, span and twiddles
    for a, b in zip(ours[3:9], theirs[3:9]):
        assert a.split(";")[0] == b.split(";")[0] and a.endswith(b[-16:])
    recursive.print_recursion_tree(8)
    mine = capsys.readouterr().out
    jx_recursive.print_recursion_tree(8)
    assert mine == capsys.readouterr().out
    with pytest.raises(ValueError):
        iterative.explain(12)


_jx_rfft = jax.jit(jx_real.rfft)
_jx_irfft = jax.jit(jx_real.irfft, static_argnums=1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 15, 16, 64, 100, 1024])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_rfft_irfft(n, dtype, tol):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(dtype)
    X = port(real_fft.rfft, x)
    jX = np.asarray(_jx_rfft(jnp.asarray(x)))
    assert X.shape == jX.shape == (3, n // 2 + 1)
    assert rel_err(X, jX) <= tol
    y = port(real_fft.irfft, X, n)
    jy = np.asarray(_jx_irfft(jnp.asarray(jX), n))
    assert y.dtype == jy.dtype and rel_err(y, jy) <= tol
    np.testing.assert_array_equal(real_fft.rfftfreq(n, 0.5), jx_real.rfftfreq(n, 0.5))
    with pytest.raises(TypeError):
        real_fft.rfft(tt(x.astype(np.complex64)))


@pytest.mark.parametrize("shape", [(16, 32), (2, 12, 10), (64, 64)])
def test_fft2_ifft2_fftn(shape):
    x = cx(sum(shape), shape)
    jx_all = jax.jit(lambda v: (jx_fft2d.fft2(v), jx_fft2d.fftn(v),
                                jx_fft2d.fftn(v, (0,), 1)))
    j2, jn, j0 = (np.asarray(a) for a in jx_all(jnp.asarray(x)))
    got = port(fft2d.fft2, x)
    assert rel_err(got, j2) <= 1e-10 and rel_err(got, np.fft.fft2(x)) <= 1e-10
    back = port(fft2d.ifft2, got)
    assert rel_err(back, np.asarray(jax.jit(jx_fft2d.ifft2)(jnp.asarray(got)))) <= 1e-10
    assert rel_err(port(fft2d.fftn, x), jn) <= 1e-10
    assert rel_err(port(fft2d.fftn, x, (0,), 1), j0) <= 1e-10
    for axes in (None, -1, (0, -1)):
        np.testing.assert_array_equal(port(fft2d.fftshift, x, axes),
                                      np.asarray(jx_fft2d.fftshift(jnp.asarray(x), axes)))
        np.testing.assert_array_equal(port(fft2d.ifftshift, x, axes),
                                      np.asarray(jx_fft2d.ifftshift(jnp.asarray(x), axes)))


def test_public_2d_and_real_names():
    x = cx(3, (8, 12))
    assert rel_err(port(fftlab_torch.fft2, x), np.asarray(fftlab.fft2(jnp.asarray(x)))) <= 1e-10
    assert rel_err(port(fftlab_torch.ifft2, x), np.asarray(fftlab.ifft2(jnp.asarray(x)))) <= 1e-10
    np.testing.assert_array_equal(port(fftlab_torch.fftshift, x),
                                  np.asarray(fftlab.fftshift(jnp.asarray(x))))
    r = x.real.copy()
    assert rel_err(port(fftlab_torch.rfft, r), np.asarray(fftlab.rfft(jnp.asarray(r)))) <= 1e-10
    X = np.fft.rfft(r)
    assert rel_err(port(fftlab_torch.irfft, X, 12),
                   np.asarray(fftlab.irfft(jnp.asarray(X), 12))) <= 1e-10


def test_to_split_from_split():
    x = cx(5, (3, 40), np.complex64)
    re, im = fftlab_torch.to_split(tt(x))
    jre, jim = fftlab.to_split(x)
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    assert re.is_contiguous() and im.is_contiguous()
    z = fftlab_torch.from_split(re, im)
    np.testing.assert_array_equal(z.numpy(), fftlab.from_split(jre, jim))
    r0, i0 = split_stockham.to_split(tt(x.real.copy()))
    assert not i0.any() and torch.equal(r0, tt(x.real.copy()))
    # numpy input goes to the card by default, or where the caller says
    cpu = split_stockham.to_split(x, device="cpu")
    np.testing.assert_array_equal(cpu[0].numpy(), x.real)


@functools.lru_cache(maxsize=None)
def _jax_fft2_split(shape, direction):
    x = cx(shape[-1], shape, np.complex64)
    yr, yi = jax.jit(lambda a, b: jx_split.fft2_split(a, b, direction, route=False))(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("shape", [(8, 16), (2, 6, 10), (16, 8192)])
@pytest.mark.parametrize("route", [None, True, False])
@pytest.mark.parametrize("direction", [-1, 1])
def test_fft2_split(shape, route, direction):
    x = cx(shape[-1], shape, np.complex64)
    got = split_stockham.fft2_split(tt(x.real.copy()), tt(x.imag.copy()), direction,
                                    route=route)
    g = got[0].numpy() + 1j * got[1].numpy()
    assert rel_err(g, _jax_fft2_split(shape, direction)) <= TOL_F32
    x64 = x.astype(np.complex128)
    assert rel_err(g, np.fft.fft2(x64) if direction == -1 else np.fft.ifft2(x64)) <= TOL_F32


def test_types_helpers():
    for n in range(0, 300):
        for base in (2, 3, 4):
            assert types.is_power_of(n, base) == jx_types.is_power_of(n, base)
    for d in (np.float32, np.float64, np.complex64, np.complex128, np.int32, np.float16):
        assert types.complex_dtype_for(d) == jx_types.complex_dtype_for(d)
        assert types.real_dtype_for(d) == jx_types.real_dtype_for(d)
    assert types.complex_dtype_for(torch.float64) == torch.complex128
    assert types.complex_dtype_for(torch.float32) == torch.complex64
    assert types.real_dtype_for(torch.complex64) == torch.float32
    x = np.ones((2, 5), np.float32)
    assert types.transform_size(x) == jx_types.transform_size(jnp.asarray(x)) == 5
    t = types.as_complex_array(x, device="cpu")
    assert t.dtype == torch.complex64 and t.device.type == "cpu"
    assert types.as_complex_array(tt(x.astype(np.float64))).dtype == torch.complex128


def test_non_tensor_input_needs_the_card_or_cpu(monkeypatch):
    """Numpy input goes to the card by default; without one it raises
    rather than running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = cx(0, (2, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fftlab_torch.fft(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        types.as_complex_array(x)
    got = fftlab_torch.fft(types.as_complex_array(x, device="cpu"))
    assert rel_err(got.numpy(), np.fft.fft(x)) <= 1e-10
