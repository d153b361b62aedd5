"""Build and load the port's CUDA kernels.

`fftlab_torch/csrc/*.cu` compile with nvcc for sm_90a into one shared
library with a plain C interface, at first use, into
`fftlab_torch/_build/<hash of the sources>/`. The library is loaded with
ctypes; every pointer and the stream are declared `c_void_p`, so none is
cut to 32 bits. Each C function returns a `cudaError_t`, which
`check` turns into a RuntimeError.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfftlab_torch_kernels.so"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every exported kernel entry (all return int).
SIGNATURES = {
    # xr, xi, yr, yi, tw, batch, log_n, direction, scale, stream
    "fftlab_fft_rows": (_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P),
    # xr, xi, mr, mi, tw1, a_tab, p_tab, batch, log_l1, log_l2, log_w,
    # direction, stream
    "fftlab_fourstep_pass1": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # mr, mi, yr, yi, tw2, batch, log_l1, log_l2, log_r, direction, scale,
    # stream
    "fftlab_fourstep_pass2": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else RuntimeError."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(CUDA_HOME_DEFAULT) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $PATH and "
        f"{CUDA_HOME_DEFAULT}): the CUDA kernels of fftlab_torch are built "
        f"from {CSRC} at first use and need the CUDA toolkit")


def compile_library(out: Path) -> Path:
    """Compile every csrc/*.cu into the shared library `out`."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    so = BUILD_ROOT / source_digest() / LIB_NAME
    if not so.is_file():
        compile_library(so)
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.fftlab_error_string.argtypes = [ctypes.c_int]
    lib.fftlab_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if rc != 0:
        msg = lib.fftlab_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
