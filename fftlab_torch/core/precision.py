"""Full float32 precision for the port's tensor-op contractions and
convolutions.

The JAX package pins `Precision.HIGHEST` on its contractions
(fftlab/algos/split_stockham.py). PyTorch takes a process-wide setting
instead: after `torch.set_float32_matmul_precision("high")` a float32
matmul on the card runs in TF32, and after "medium" in bfloat16 (on the
CPU too), which costs the FFT 60-70 dB of SNR. Convolutions take their own
settings: cuDNN runs a float32 `conv1d` in TF32 while
`torch.backends.cudnn.allow_tf32` is True, PyTorch's default, and the
CPU's oneDNN in bfloat16 after `torch.backends.mkldnn.conv.fp32_precision
= "bf16"`. `full_float32` runs a block at "highest" with TF32 off for
matmuls and convolutions alike, and gives the caller's settings back
when the block ends, so the settings outside the port's calls are
untouched.

`matmul_precision(level)` is its sibling for the one place that lowers
precision on purpose, `algos/lowprec.py`'s modes: the block's float32
matmuls run at PyTorch's tier `level` ("highest", "high": TF32 tensor
cores on the card, "medium": bfloat16 where PyTorch has such a kernel),
convolutions at full float32 as in `full_float32`.

The setting is process-wide, so the blocks of all threads share one
save and one restore: under a lock, the first block to enter saves the
caller's setting, and the last to leave restores it (a depth count),
however the threads' blocks interleave. While blocks are open, the
matmuls run at the highest level any of them asks for, so a reduced
block never lowers the precision of a `full_float32` block of another
thread (it runs at full precision while one is open); a setting another
thread makes then is replaced by the saved one when the last block
leaves.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

# PyTorch's float32 matmul tiers, lowest first
LEVELS = ("medium", "high", "highest")

_lock = threading.Lock()
_open = collections.Counter()  # blocks open by level, over all threads
_saved = None  # the caller's settings, saved by the first block to enter
_applied = None  # the level set while blocks are open


def _backends():
    """The per-backend settings of newer PyTorch (`fp32_precision`)."""
    return (torch.backends, torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


def _conv_backends():
    """The per-backend convolution settings this PyTorch has: cuDNN's conv
    and RNN (the legacy `cudnn.allow_tf32` sets both) and oneDNN's conv."""
    found = []
    for parent, names in ((torch.backends.cudnn, ("conv", "rnn")),
                          (torch.backends.mkldnn, ("conv",))):
        for name in names:
            b = getattr(parent, name, None)
            if b is not None and hasattr(b, "fp32_precision"):
                found.append(b)
    return tuple(found)


def _full_conv_backends():
    """The settings `full_float32` sets to "ieee": the convs', not the RNN's."""
    return tuple(b for b in _conv_backends() if b is not torch.backends.cudnn.rnn)


def _save_matmul():
    """The caller's matmul setting: (legacy precision, allow_tf32), or
    the per-backend strings where PyTorch refuses to read the legacy one
    (a caller mixed the two APIs)."""
    try:
        return ("legacy", torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)
    except RuntimeError:
        return ("per_backend", [(b, b.fp32_precision) for b in _backends()])


def _restore_matmul(saved) -> None:
    if saved[0] == "per_backend":
        for b, value in saved[1]:
            b.fp32_precision = value
        return
    torch.set_float32_matmul_precision(saved[1])
    if torch.backends.cuda.matmul.allow_tf32 != saved[2]:
        torch.backends.cuda.matmul.allow_tf32 = saved[2]


def _save_conv():
    """The caller's convolution setting: the legacy `cudnn.allow_tf32`
    (None where PyTorch refuses to read it) and the per-backend strings."""
    try:
        legacy = torch.backends.cudnn.allow_tf32
    except RuntimeError:
        legacy = None
    return legacy, [(b, b.fp32_precision) for b in _conv_backends()]


def _restore_conv(saved) -> None:
    """The legacy flag first (its setter rewrites cuDNN's strings), then
    the strings as they were."""
    legacy, strings = saved
    if legacy is not None:
        torch.backends.cudnn.allow_tf32 = legacy
    for b, value in strings:
        if b.fp32_precision != value:
            b.fp32_precision = value


def _set(level: str, conv_legacy: bool) -> None:
    """Matmuls at `level`, convs at full float32; `conv_legacy`: the
    caller's `cudnn.allow_tf32` reads, so it is set through the legacy
    flag too and stays readable."""
    torch.set_float32_matmul_precision(level)
    if level == "highest" and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
    if conv_legacy:
        torch.backends.cudnn.allow_tf32 = False
    for b in _full_conv_backends():
        b.fp32_precision = "ieee"


def _apply_top() -> None:
    """Set the highest level of the open blocks, if it is not set already."""
    global _applied
    top = max(_open, key=LEVELS.index)
    if top != _applied:
        _set(top, _saved[1][0] is not None)
        _applied = top


@contextlib.contextmanager
def _block(level: str):
    """Open a block at `level` (see the module docstring)."""
    global _saved, _applied
    with _lock:
        if not _open:
            _saved = (_save_matmul(), _save_conv())
        _open[level] += 1
        _apply_top()
    try:
        yield
    finally:
        with _lock:
            _open[level] -= 1
            if not _open[level]:
                del _open[level]
            if _open:
                _apply_top()
            else:
                _restore_matmul(_saved[0])
                _restore_conv(_saved[1])
                _saved = _applied = None


def full_float32():
    """Run the block with float32 matmuls and convolutions at full
    precision: matmul precision "highest",
    `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` False, and the per-backend conv
    settings (`torch.backends.cudnn.conv`, `torch.backends.mkldnn.conv`)
    at "ieee"; the caller's settings are restored in a `finally` when the
    last open block (of any thread) leaves."""
    return _block("highest")


def matmul_precision(level: str):
    """Run the block with float32 matmuls at PyTorch's tier `level`, one of
    `LEVELS`, and convolutions at full float32; the caller's settings are
    restored as by `full_float32`. While a block of a higher level is
    open in any thread, the matmuls run at that level."""
    if level not in LEVELS:
        raise ValueError(f"matmul precision must be one of {LEVELS}; got {level!r}")
    return _block(level)
