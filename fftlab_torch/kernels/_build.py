"""Build and load the port's CUDA kernels.

`fftlab_torch/csrc/*.cu` compile with nvcc for sm_90a, one nvcc process
per source, all started together, and link into one shared library with
a plain C interface, at first use, into
`fftlab_torch/_build/<hash of the sources>/`. The library is loaded with
ctypes; every pointer and the stream are declared `c_void_p`, so none is
cut to 32 bits. Each C function returns a `cudaError_t`. `launch` is
the one place a kernel is called from Python: the device guard, the
stream, the call, a RuntimeError for an error, the count and the span.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from fftlab_torch.utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfftlab_torch_kernels.so"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# ptxas's report of every kernel (registers, spills), kept beside the library
PTXAS_LOG = "ptxas.log"
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


class Geometry(ctypes.Structure):
    """csrc/fft_reg.cuh `Geometry`, passed by value: the launch of a
    register-engine kernel (kernels/_common.py `TileGeometry`)."""
    _fields_ = [("threads", _I), ("smem", _I), ("log_last", _I), ("log_pad", _I),
                ("stride", _I)]


_G = Geometry


class StftLayout(ctypes.Structure):
    """csrc/real.cu `StftLayout`, passed by value: the shared memory of one
    `stft_frames` block (kernels/stft_vmem.py `stft_layout`)."""
    _fields_ = [(name, _I) for name in
                ("nseg", "words", "seg_pitch", "span", "window", "stage_pitch", "total")]

# C signature of every exported kernel entry (all return int).
SIGNATURES = {
    # xr, xi, yr, yi, tw, batch, log_n, geometry, direction, scale, stream
    "fftlab_fft_rows": (_P, _P, _P, _P, _P, _LL, _I, _G, _I, _F, _P),
    # xr, xi, mr, mi, tw1, a_tab, p_tab, s_tab, batch, log_l1, log_l2, log_w,
    # geometry, direction, stream
    "fftlab_fourstep_pass1": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _I, _P),
    # xr, xi, mr, mi, tw1, batch, log_l1, log_l2, log_w, geometry,
    # direction, stream
    "fftlab_fourstep_pass1_no_twiddle": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _I, _P),
    # mr, mi, yr, yi, tw2, batch, log_l1, log_l2, log_r, geometry,
    # direction, scale, stream
    "fftlab_fourstep_pass2": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _I, _F, _P),
    # mr, mi, tw_fwd, tw_inv, hr, hi, a_tab, p_tab, batch, log_l1, log_l2,
    # log_r, geometry, stream
    "fftlab_fourstep_pass2_sandwich": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                       _G, _P),
    # xr, xi, yr, yi, tw_fwd, tw_inv, hr, hi, batch, log_n, geometry, scale,
    # stream
    "fftlab_filter_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _G, _F, _P),
    # xr, xi, yr, yi, tw_fwd, tw_inv, hr, hi, channels, n, hop, halo, log_l,
    # log_t, geometry, scale, stream
    "fftlab_os_filter": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _G,
                         _F, _P),
    # x, mr, mi, tw1, a_tab, p_tab, s_tab, batch, log_l1, log_l2, log_w,
    # geometry, direction, stream
    "fftlab_fourstep_pass1_packed": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _I,
                                     _P),
    # mr, mi, y, tw2, batch, log_l1, log_l2, log_r, geometry, direction,
    # scale, stream
    "fftlab_fourstep_pass2_interleaved": (_P, _P, _P, _P, _LL, _I, _I, _I, _G, _I, _F,
                                          _P),
    # mr, mi, xr, xi, tw2, utw, batch, log_l1, log_l2, log_r, geometry,
    # scale, stream
    "fftlab_fourstep_pass2_unpack": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _F, _P),
    # x, zr, zi, total, stream
    "fftlab_pack_real": (_P, _P, _P, _LL, _P),
    # zr, zi, x, total, stream
    "fftlab_interleave": (_P, _P, _P, _LL, _P),
    # zr, zi, xr, xi, tw, rows, m, scale, stream
    "fftlab_herm_unpack": (_P, _P, _P, _P, _P, _LL, _I, _F, _P),
    # xr, xi, zr, zi, tw, rows, m, stream
    "fftlab_herm_repack": (_P, _P, _P, _P, _P, _LL, _I, _P),
    # x, n, win, tw, utw, yr, yi, n_frames, hop, log_m, log_t, bins,
    # geometry, layout, stream
    "fftlab_stft_frames": (_P, _LL, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _G, StftLayout,
                           _P),
    # xr, xi, mr, mi, tw1, a_tab, p_tab, s_tab, batch, log_f1, log_l1, log_l2,
    # log_w, geometry, direction, stream
    "fftlab_fourstep_pass1_swap": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _G,
                                   _I, _P),
    # xr, xi, yr, yi, tw1, a_tab, p_tab, rows, log_f1, log_l1, log_l2, log_g,
    # geometry, direction, stream
    "fftlab_fused_stage": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _G, _I, _P),
    # mr, mi, yr, yi, tw2, batch, log_l1, log_l2, log_r, geometry, direction,
    # scale, stream
    "fftlab_stage_leaf": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _G, _I, _F, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails. Returns
    their standard error, joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]  # waits for every process
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{out}{err}")
    return "".join(err for _, err in outs)


def compile_library(out: Path) -> Path:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link them
    into the shared library `out`."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in sources]
    report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                       for src, o in zip(sources, objs)])
    out.with_name(PTXAS_LOG).write_text(report)
    tmp = out.with_name(f"{out.name}.{tag}")
    _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


@functools.cache
@trace.setup_span("library")
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none: the
    set-up span `library`, with `digest`, `build` (nvcc, where it runs)
    and `dlopen` under it, counted in COUNTS["library_builds"] and
    COUNTS["library_loads"] (utils/trace.py)."""
    with trace.setup_span("digest"):
        so = BUILD_ROOT / source_digest() / LIB_NAME
    if not so.is_file():
        with trace.setup_span("build"):
            compile_library(so)
        trace.COUNTS["library_builds"] += 1
    with trace.setup_span("dlopen"):
        lib = ctypes.CDLL(str(so))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.fftlab_error_string.argtypes = [ctypes.c_int]
        lib.fftlab_error_string.restype = ctypes.c_char_p
    trace.COUNTS["library_loads"] += 1
    return lib


def ptxas_report() -> list[dict]:
    """Registers and spills of every kernel of the built library, from
    ptxas's report: [{"kernel", "registers", "spill_stores",
    "spill_loads"}], the kernel's name shortened from its mangled form
    with its integer template arguments (`fourstep_pass1_kernel<0, 10>`)."""
    log = BUILD_ROOT / source_digest() / PTXAS_LOG
    rows, cur = [], None
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line):
            name, rest = m.group(2)[: int(m.group(1))], m.group(2)[int(m.group(1)):]
            if t := re.match(r"I((?:Li\d+E)+)E", rest):
                name += "<" + ", ".join(re.findall(r"Li(\d+)E", t.group(1))) + ">"
            cur = {"kernel": name}
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
    return rows


def launch(entry: str, key: str, counts: dict, like: torch.Tensor, args: tuple,
           mark=trace.OFF) -> None:
    """Call `entry` (a SIGNATURES name) with `args` and the current stream
    of `like`'s device, under its guard; a CUDA error raises a RuntimeError
    naming `key` (the kernel's LAUNCHES key), else `counts[key]` rises by
    one. `mark` (`trace.phases()`) starts the `call` phase here; while the
    recorder is on, the launch is recorded as the span `key`."""
    mark()
    lib = load_library()
    with torch.cuda.device(like.device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if rc != 0:
        msg = lib.fftlab_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{key} failed: CUDA error {rc} ({msg})")
    counts[key] += 1
    if mark is not trace.OFF:
        trace.launch(key, mark)
