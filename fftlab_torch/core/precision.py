"""Full float32 precision for the port's tensor-op contractions.

The JAX package pins `Precision.HIGHEST` on its contractions
(fftlab/algos/split_stockham.py). PyTorch takes a process-wide setting
instead: after `torch.set_float32_matmul_precision("high")` a float32
matmul on the card runs in TF32, and after "medium" in bfloat16 (on the
CPU too), which costs the FFT 60-70 dB of SNR. `full_float32` runs a
block at "highest" with TF32 off and gives the caller's setting back
when the block ends, so the setting outside the port's calls is
untouched.

The setting is process-wide, so the blocks of all threads share one
save and one restore: under a lock, the first block to enter saves the
caller's setting and sets full precision, and the last to leave
restores it (a depth count), however the threads' blocks interleave.
While any block is open, every thread's matmuls run at "highest", and a
setting another thread makes then is replaced by the saved one when the
last block leaves.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0  # blocks open, over all threads
_saved = None  # the caller's setting, saved by the first block to enter


def _backends():
    """The per-backend settings of newer PyTorch (`fp32_precision`)."""
    return (torch.backends, torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


def _save():
    """The caller's setting: (legacy precision, allow_tf32), or the
    per-backend strings where PyTorch refuses to read the legacy one (a
    caller mixed the two APIs)."""
    try:
        return ("legacy", torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)
    except RuntimeError:
        return ("per_backend", [(b, b.fp32_precision) for b in _backends()])


def _restore(saved) -> None:
    if saved[0] == "per_backend":
        for b, value in saved[1]:
            b.fp32_precision = value
        return
    torch.set_float32_matmul_precision(saved[1])
    if torch.backends.cuda.matmul.allow_tf32 != saved[2]:
        torch.backends.cuda.matmul.allow_tf32 = saved[2]


@contextlib.contextmanager
def full_float32():
    """Run the block with float32 matmuls at full precision: precision
    "highest" and `torch.backends.cuda.matmul.allow_tf32` False; the
    caller's setting is restored in a `finally` when the last open block
    (of any thread) leaves."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _save()
            torch.set_float32_matmul_precision("highest")
            if torch.backends.cuda.matmul.allow_tf32:
                torch.backends.cuda.matmul.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _restore(_saved)
                _saved = None
