"""Helpers shared by the fftlab_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, cast to float32, and handed to
both packages as numpy arrays; results come back as complex128 numpy.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from fftlab_torch.kernels import _build

# Decided when each test runs, not at import: the condition string is
# evaluated in the test module's namespace, which imports torch.
requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA card: runs the hand-written kernels on the H100")


# (direction, caller scale): forward, inverse, forward with scale=0.5
CASES = [(-1, None), (1, None), (-1, 0.5)]
CASE_IDS = ["fwd", "inv", "fwd_scale"]


def whole_scale(n: int, direction: int, scale) -> float:
    """The output scale a case asks for: the inverse's 1/n times `scale`."""
    return (1.0 / n if direction == 1 else 1.0) * (scale or 1.0)


def hide_nvcc(monkeypatch, tmp_path) -> None:
    """Make every place `_build.find_nvcc` looks come up empty."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path / "cuda"))


def snr_db(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(10 * np.log10(
        np.sum(np.abs(want) ** 2)
        / max(np.sum(np.abs(got - want) ** 2), 1e-30)))


def planes(seed: int, shape) -> tuple[np.ndarray, np.ndarray]:
    """A float32 (re, im) pair of standard normals."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def tt(a: np.ndarray, device: str = "cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def cplx(re, im) -> np.ndarray:
    """A (re, im) pair of torch or JAX arrays -> complex128 numpy."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    return as_np(re).astype(np.float64) + 1j * as_np(im).astype(np.float64)


def oracle(xr, xi, direction: int, scale: float = 1.0) -> np.ndarray:
    """float64 DFT along the last axis in `direction` (unscaled), times
    `scale`."""
    z = np.asarray(xr, np.float64) + 1j * np.asarray(xi, np.float64)
    n = z.shape[-1]
    y = np.fft.fft(z) if int(direction) == -1 else np.fft.ifft(z) * n
    return y * scale


def jax_native():
    """fftlab's native library, loaded with retries. The JAX loader runs
    `make` into native/ on first use in each process, and another test
    process may be running the same build at that moment: a half-written
    library fails to load, and the JAX loader keeps that failure. A retry
    after the other build has finished loads the finished file."""
    from fftlab.native import lib as jx_lib

    for attempt in range(5):
        try:
            return jx_lib.load_native_lib()
        except RuntimeError:
            if attempt == 4:
                raise
            jx_lib._ERR = None
            time.sleep(2)
