"""Build and load the native runtime library (counterpart of
fftlab/native/lib.py).

The C++ sources are the repo's `native/` (WAV IO, the SPSC ring buffer,
the Q15 FFT, the float64 host FFT), compiled with the Makefile's own
command, `g++ -O2 -Wall -Wextra -fPIC -std=c++17 -shared`, run directly
(no `make`), at first use, into
`fftlab_torch/_build/native/<hash of the sources and flags>/`. The
build runs under an `fcntl` lock on that directory and ends with an
atomic rename, so processes that build at once never load half a file.
A stale build is never reused after a source changes: its hash differs.

There is no fallback to a library built elsewhere (`native/`'s own
`libfftlab_native.so`): a missing compiler or a failed build raises
RuntimeError with the compiler's standard error.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
# the Makefile's SRCS, in its order
SOURCES = ("wavio.cpp", "ringbuffer.cpp", "q15_fft.cpp", "fft64.cpp")
CXXFLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17")
LDFLAGS = ("-shared",)
BUILD_ROOT = _PKG / "_build" / "native"
LIB_NAME = "libfftlab_native.so"
BUILD_TIMEOUT_S = 300


def source_digest() -> str:
    """Hash of the sources and the compiler flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources is, or will be, built."""
    return BUILD_ROOT / source_digest() / LIB_NAME


def build_library(out: Path) -> None:
    """Compile the sources into `out` unless another process has: under an
    exclusive `fcntl` lock on `out`'s directory, into a temporary name
    renamed to `out` when the compiler succeeds."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "native library unavailable: g++ not found on $PATH (fftlab_torch.native "
            f"builds {NATIVE_DIR} at first use)")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.is_file():
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXXFLAGS, *LDFLAGS, "-o", str(tmp),
               *(str(NATIVE_DIR / name) for name in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library unavailable: {' '.join(cmd)} took "
                               f"over {BUILD_TIMEOUT_S} s") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library unavailable: {' '.join(cmd)} exited "
                               f"{proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.fftlab_wav_info.restype = c.c_int32
    lib.fftlab_wav_info.argtypes = [
        c.c_char_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
    ]
    lib.fftlab_wav_read_f32.restype = c.c_int64
    lib.fftlab_wav_read_f32.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_int64,
    ]
    lib.fftlab_wav_write_pcm16.restype = c.c_int32
    lib.fftlab_wav_write_pcm16.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int32, c.c_int32,
    ]
    lib.fftlab_ring_create.restype = c.c_void_p
    lib.fftlab_ring_create.argtypes = [c.c_int64]
    lib.fftlab_ring_destroy.restype = None
    lib.fftlab_ring_destroy.argtypes = [c.c_void_p]
    for name in ("fftlab_ring_capacity", "fftlab_ring_available",
                 "fftlab_ring_space"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    for name in ("fftlab_ring_write", "fftlab_ring_read"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    lib.fftlab_ring_peek_hop.restype = c.c_int64
    lib.fftlab_ring_peek_hop.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int64,
    ]
    lib.fftlab_q15_fft.restype = c.c_int32
    lib.fftlab_q15_fft.argtypes = [
        c.POINTER(c.c_int16), c.POINTER(c.c_int16), c.c_int32, c.c_int32,
    ]
    lib.fftlab_q15_normalize.restype = c.c_int32
    lib.fftlab_q15_normalize.argtypes = [
        c.POINTER(c.c_int16), c.POINTER(c.c_int16), c.c_int32,
    ]
    lib.fftlab_fft64.restype = c.c_int32
    lib.fftlab_fft64.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.c_int64, c.c_int64, c.c_int32,
    ]


@functools.cache
def load_native_lib() -> ctypes.CDLL:
    """The native library, built first if these sources have none; raises
    RuntimeError with the compiler's output if it cannot be built."""
    so = library_path()
    if not so.is_file():
        build_library(so)
    try:
        lib = ctypes.CDLL(str(so))
        _declare(lib)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"native library unavailable: {so}: {e}") from e
    return lib


def native_available() -> bool:
    try:
        load_native_lib()
        return True
    except RuntimeError:
        return False
