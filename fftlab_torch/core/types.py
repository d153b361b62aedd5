"""Direction enum, integer helpers and dtype mapping (counterpart of
fftlab/core/types.py).

The split-plane path carries complex data as two float32 tensors of one
shape; the complex API (`plan/api.py`, `algos/`) takes complex64 and
complex128 tensors, which the card computes natively.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class Direction(enum.IntEnum):
    """Transform direction: FORWARD = -1, INVERSE = +1; the twiddle basis
    is exp(2*pi*i*direction*k/n)."""

    FORWARD = -1
    INVERSE = 1


FORWARD = Direction.FORWARD
INVERSE = Direction.INVERSE


def is_power_of_two(n: int) -> bool:
    """True if n is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def log2_int(n: int) -> int:
    """Exact integer log2; raises for non-powers-of-two."""
    if not is_power_of_two(n):
        raise ValueError(f"log2_int requires a power of two, got {n}")
    return n.bit_length() - 1


def is_power_of(n: int, base: int) -> bool:
    """True if n is a positive power of `base` (used for radix-4 gating)."""
    if n <= 0:
        return False
    while n % base == 0:
        n //= base
    return n == 1


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _like(d: np.dtype, dtype):
    """`d` as the kind of dtype the caller gave: torch in, torch out."""
    return getattr(torch, d.name) if isinstance(dtype, torch.dtype) else d


def torch_dtype(dtype) -> torch.dtype:
    """A torch or numpy dtype as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, _np_dtype(dtype).name)


def complex_dtype_for(dtype):
    """Complex dtype matching a real/complex dtype, numpy or torch: a
    float64 maps to complex128, any other real to complex64."""
    d = _np_dtype(dtype)
    if d.kind != "c":
        d = np.dtype(np.complex128 if d == np.float64 else np.complex64)
    return _like(d, dtype)


def real_dtype_for(dtype):
    """Real dtype matching a complex/real dtype, numpy or torch."""
    d = _np_dtype(dtype)
    if d.kind == "c":
        d = np.dtype(np.float64 if d == np.complex128 else np.float32)
    return _like(d, dtype)


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises,
    never falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fftlab_torch runs on the card by default and no CUDA device is "
            'available; pass a CPU tensor or device="cpu" to run on the CPU')
    return dev


def as_tensor(x, device="cuda") -> torch.Tensor:
    """A tensor stays on its device; anything else (numpy, lists) goes to
    `device`: the card by default (`require_device`); `device="cpu"` runs
    on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    dev = require_device(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dev)


def as_complex_array(x, device="cuda") -> torch.Tensor:
    """Promote a real tensor to its matching complex dtype; pass complex
    through. Non-tensors are placed as `as_tensor` places them."""
    x = as_tensor(x, device)
    if not x.is_complex():
        x = x.to(complex_dtype_for(x.dtype))
    return x


def transform_size(x, axis: int = -1) -> int:
    """Transform length along `axis`."""
    return int(x.shape[axis])


def to_host(x) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array
    (the host epilogues' input)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
