"""WAV file IO (native/wavio.cpp through ctypes; counterpart of
fftlab/native/wav.py)."""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab_torch.core.types import to_host
from fftlab_torch.native.lib import load_native_lib

_ERRORS = {-1: "cannot open file", -2: "not a RIFF/WAVE file",
           -3: "unsupported sample format", -4: "truncated file"}


def wav_info(path: str) -> dict:
    """{'sample_rate', 'channels', 'frames', 'bits'} of a WAV file."""
    lib = load_native_lib()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    fr = ctypes.c_int64()
    bits = ctypes.c_int32()
    rc = lib.fftlab_wav_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(fr),
                             ctypes.byref(bits))
    if rc != 0:
        raise OSError(f"wav_info({str(path)!r}): {_ERRORS.get(rc, rc)}")
    return {"sample_rate": sr.value, "channels": ch.value,
            "frames": fr.value, "bits": bits.value}


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 numpy [frames] or [frames, channels] in
    [-1, 1], sample_rate). Supports PCM 8/16/24/32 and float32."""
    info = wav_info(path)
    lib = load_native_lib()
    n = info["frames"] * info["channels"]
    out = np.empty(n, dtype=np.float32)
    got = lib.fftlab_wav_read_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got < 0:
        raise OSError(f"read_wav({str(path)!r}): {_ERRORS.get(got, got)}")
    out = out[:got]
    ch = info["channels"]
    if ch > 1:
        # a truncated file can end mid-frame: keep the whole frames
        out = out[: (len(out) // ch) * ch].reshape(-1, ch)
    return out, info["sample_rate"]


def write_wav(path: str, data, sample_rate: int) -> None:
    """Write float32 samples in [-1, 1] as 16-bit PCM. data: numpy or a
    tensor, [frames] or [frames, channels]."""
    lib = load_native_lib()
    a = np.ascontiguousarray(to_host(data), dtype=np.float32)
    if a.ndim == 1:
        frames, channels = len(a), 1
    elif a.ndim == 2:
        frames, channels = a.shape
    else:
        raise ValueError(f"expected 1D or 2D samples, got shape {a.shape}")
    rc = lib.fftlab_wav_write_pcm16(
        str(path).encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, int(sample_rate))
    if rc != 0:
        raise OSError(f"write_wav({str(path)!r}): {_ERRORS.get(rc, rc)}")
