"""One rank of the port's distributed tests on the CPU
(tests/test_torch_dist.py, test_torch_dist_split.py,
test_torch_dist_pipelines.py, test_torch_multihost.py, test_torch_entry.py).

Each test module starts `world` of these processes once, over gloo with
a file store, at matmul precision "medium". Every rank runs every case of the module's suite on the
same inputs (made here from numpy seeds, float32 / complex64), and rank
0 writes the inputs, the gathered whole outputs and the exception class
of each refused call to one .npz, under "<case>/<name>". The test
module reads them, runs the JAX functions on the same inputs and
compares: one parametrised test a case.

This file imports only torch, numpy and fftlab_torch.

Usage: python tests/_torch_dist_worker.py <suite> <rank> <world> <init file> <out.npz>
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np
import torch

# seconds a collective waits for its peers before it raises: a hung case
# fails its test instead of running the suite into its time limit
TIMEOUT_S = 60


def f32(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def raised(fn) -> str:
    """The class name of what `fn()` raises, or "none"."""
    try:
        fn()
    except Exception as e:  # the class is the result the test compares
        return type(e).__name__
    return "none"


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def pair(t) -> np.ndarray:
    """A (re, im) pair of tensors as one complex array."""
    return host(t[0]) + 1j * host(t[1])


SUITES: dict[str, list] = {}


def case(suite: str):
    def register(fn):
        SUITES.setdefault(suite, []).append(fn)
        return fn
    return register


# ---------------------------------------------------------------------------
# suite "dist": tests/test_dist.py (complex four-step, overlap-save,
# Welch, STFT, DP batches, the sharded plan, the mesh helpers)
# ---------------------------------------------------------------------------


@case("dist")
def sharded(m):
    from fftlab_torch.dist import four_step_fft_sharded

    out = {}
    for n in (4096, 65536):
        x = c64(2, n)
        out[f"x{n}"], out[f"y{n}"] = x, host(four_step_fft_sharded(x, m["x"], "x"))
    return out


@case("dist")
def sharded_inverse(m):
    from fftlab_torch.dist import four_step_fft_sharded

    x = c64(3, 4096)
    X = four_step_fft_sharded(x, m["x"], "x")
    back = four_step_fft_sharded(X, m["x"], "x", direction=1)
    return {"x": x, "back": host(back)}


@case("dist")
def sharded_batched(m):
    from fftlab_torch.dist import four_step_fft_sharded

    x = c64(4, (3, 4096))
    return {"x": x, "y": host(four_step_fft_sharded(x, m["x"], "x"))}


@case("dist")
def matrix_form(m):
    from fftlab_torch.dist import four_step_fft_sharded, gather

    x = c64(5, 4096)
    y = four_step_fft_sharded(x, m["x"], "x", flatten=False)
    return {"x": x, "block_shape": np.asarray(y.shape),
            "y": host(gather(y, m["x"], "x", -1))}


@case("dist")
def indivisible(m):
    from fftlab_torch.dist import four_step_fft_sharded
    from fftlab_torch.plan.api import plan_dft_1d_sharded

    x = np.zeros(36, np.complex64)
    return {"four_step": raised(lambda: four_step_fft_sharded(x, m["x"], "x", n1=6)),
            "plan": raised(lambda: plan_dft_1d_sharded(36, m["x"], axis_name="x"))}


@case("dist")
def overlap_save(m):
    from fftlab_torch.dist import gather, overlap_save_filter_sharded

    out = {}
    x = f32(10, 8192)
    out["x"] = x
    for nh in (1, 7, 33, 129):
        h = f32(100 + nh, nh)
        y = overlap_save_filter_sharded(x, h, m["x"], "x")
        out[f"h{nh}"], out[f"y{nh}"] = h, host(gather(y, m["x"], "x", -1))
    return out


@case("dist")
def overlap_save_complex(m):
    from fftlab_torch.dist import gather, overlap_save_filter_sharded

    out = {}
    for key, x, h in (("input", c64(11, 4096), f32(12, 17)),
                      ("taps", f32(14, 4096), c64(15, 17))):
        y = overlap_save_filter_sharded(x, h, m["x"], "x")
        out[f"{key}_x"], out[f"{key}_h"] = x, h
        out[f"{key}_y"] = host(gather(y, m["x"], "x", -1))
    return out


@case("dist")
def overlap_save_batched(m):
    from fftlab_torch.dist import gather, overlap_save_filter_sharded

    x, h = f32(12, (4, 4096)), f32(13, 21)
    y = overlap_save_filter_sharded(x, h, m["x"], "x")
    return {"x": x, "h": h, "y": host(gather(y, m["x"], "x", -1))}


@case("dist")
def filterbank(m):
    from fftlab_torch.dist import gather
    from fftlab_torch.dist.overlap_save import overlap_save_filterbank_sharded

    out = {}
    for key, x, hb in (("real", f32(13, (6, 4096)), f32(130, (6, 31))),
                       ("complex_taps", f32(15, (2, 4096)), c64(150, (2, 9)))):
        y = overlap_save_filterbank_sharded(x, hb, m["dp_sp"])
        y = gather(gather(y, m["dp_sp"], "sp", -1), m["dp_sp"], "dp", 0)
        out[f"{key}_x"], out[f"{key}_h"], out[f"{key}_y"] = x, hb, host(y)
    return out


@case("dist")
def overlap_save_refusals(m):
    from fftlab_torch.dist.overlap_save import (overlap_save_filter_sharded,
                                                overlap_save_filterbank_sharded)

    return {"short": raised(lambda: overlap_save_filter_sharded(
                np.zeros(64, np.float32), np.zeros(65, np.float32), m["x"], "x")),
            "bank_short": raised(lambda: overlap_save_filterbank_sharded(
                np.zeros((2, 2048), np.float32), np.zeros((2, 1025), np.float32),
                m["dp_sp"]))}


@case("dist")
def welch(m):
    from fftlab_torch.dist import welch_psd_sharded

    x = f32(20, 8192)
    f, p = welch_psd_sharded(x, m["x"], "x", sample_rate=1000.0, window_size=256,
                             overlap=0.5)
    fs, f0, n = 1024.0, 128.0, 16384
    tone = np.sin(2 * np.pi * f0 * np.arange(n) / fs).astype(np.float32)
    ft, pt = welch_psd_sharded(tone, m["x"], "x", sample_rate=fs, window_size=512)
    return {"x": x, "freqs": f, "psd": host(p), "tone": tone, "tone_freqs": ft,
            "tone_psd": host(pt),
            "batched": raised(lambda: welch_psd_sharded(np.zeros((4, 8192), np.float32),
                                                        m["x"], "x"))}


@case("dist")
def stft(m):
    from fftlab_torch.dist import gather, stft_sharded

    x = f32(30, 16384)
    S = stft_sharded(x, m["x"], "x", 512, 256)
    x2 = f32(31, 8192)
    S2 = stft_sharded(x2, m["x"], "x", 256, 256, window="rectangular")
    return {"x": x, "S": host(gather(S, m["x"], "x", -2)), "x2": x2,
            "S2": host(gather(S2, m["x"], "x", -2))}


@case("dist")
def dp_batched_fft(m):
    from fftlab_torch.algos.stockham import stockham_fft
    from fftlab_torch.dist import gather, shard_batch

    x = c64(40, (8, 1024))
    xs = shard_batch(x, m["x"], "x")
    return {"x": x, "block_shape": np.asarray(xs.shape),
            "y": host(gather(stockham_fft(xs), m["x"], "x", 0))}


@case("dist")
def plan(m):
    from fftlab_torch.plan.api import plan_dft_1d_sharded

    x = c64(50, 4096)
    p = plan_dft_1d_sharded(4096, m["x"], axis_name="x")
    return {"x": x, "algorithm": np.asarray(p.algorithm), "y": host(p.execute(x))}


@case("dist")
def large(m):
    from fftlab_torch.dist import four_step_fft_sharded

    n, k1, k2 = 1 << 20, 12345, 400000
    t = np.arange(n)
    x = (np.exp(2j * np.pi * k1 * t / n) + 0.5 * np.exp(2j * np.pi * k2 * t / n)
         ).astype(np.complex64)
    X = host(four_step_fft_sharded(x, m["x"], "x"))
    mask = np.ones(n, bool)
    mask[[k1, k2]] = False
    return {"peak1": np.abs(X[k1]), "peak2": np.abs(X[k2]),
            "rest": np.max(np.abs(X[mask])), "n": np.asarray(n)}


@case("dist")
def mesh_helpers(m):
    import torch.distributed as dist

    from fftlab_torch.dist import make_mesh, replicate

    x = f32(60 + dist.get_rank(), 16)  # different on every rank
    same = replicate(x, m["dp_sp"])
    return {"rank0": f32(60, 16), "replicated": host(same),
            "tuple_shape": raised(lambda: make_mesh((2, 4), device_type="cpu")),
            "too_big": raised(lambda: make_mesh({"x": 16}, device_type="cpu"))}


# ---------------------------------------------------------------------------
# suite "split": tests/test_dist_split.py (split four-step, split
# overlap-save and filterbank, FilterPlan(mesh=), the 2-D transforms)
# ---------------------------------------------------------------------------


@case("split")
def four_step_split(m):
    from fftlab_torch.dist import four_step_fft_sharded_split

    out = {}
    for n in (4096, 65536):
        xr, xi = f32(n, n), f32(n + 1, n)
        out[f"x{n}"] = xr + 1j * xi
        out[f"y{n}"] = pair(four_step_fft_sharded_split(xr, xi, m["x"], axis_name="x"))
    return out


@case("split")
def chunks(m):
    from fftlab_torch.dist import four_step_fft_sharded_split

    n = 1 << 14
    xr, xi = f32(9, n), f32(10, n)
    y1 = four_step_fft_sharded_split(xr, xi, m["x"], "x", chunks=1)
    out = {"x": xr + 1j * xi, "y1": pair(y1)}
    for k in (2, 4):
        yk = four_step_fft_sharded_split(xr, xi, m["x"], "x", chunks=k)
        out[f"y{k}"] = pair(yk)
        out[f"equal{k}"] = np.asarray(all(torch.equal(a, b) for a, b in zip(y1, yk)))
    out["seven"] = raised(lambda: four_step_fft_sharded_split(xr, xi, m["x"], "x", chunks=7))
    return out


@case("split")
def four_step_split_inverse(m):
    from fftlab_torch.dist import four_step_fft_sharded_split

    xr, xi = f32(1, 4096), f32(11, 4096)
    Y = four_step_fft_sharded_split(xr, xi, m["x"], "x")
    back = four_step_fft_sharded_split(*Y, m["x"], "x", direction=1)
    return {"x": xr + 1j * xi, "back": pair(back)}


@case("split")
def four_step_split_matrix(m):
    from fftlab_torch.dist import four_step_fft_sharded_split, gather

    xr = f32(2, 4096)
    yr, yi = four_step_fft_sharded_split(xr, np.zeros_like(xr), m["x"], "x", flatten=False)
    return {"x": xr, "block_shape": np.asarray(yr.shape),
            "y": host(gather(yr, m["x"], "x", -1)) + 1j * host(gather(yi, m["x"], "x", -1))}


@case("split")
def overlap_save_split(m):
    from fftlab_torch.dist import gather, overlap_save_filter_sharded_split

    out = {}
    for nh in (7, 65):
        a, b, h = f32(nh, 8192), f32(nh + 1, 8192), f32(nh + 2, nh)
        yr, yi = overlap_save_filter_sharded_split(a, b, h, m["x"], "x")
        out[f"a{nh}"], out[f"b{nh}"], out[f"h{nh}"] = a, b, h
        out[f"y{nh}"] = host(gather(yr, m["x"], "x", -1)) + 1j * host(gather(yi, m["x"], "x", -1))
    x, h = f32(9, (3, 4096)), f32(90, 31)
    yr, _ = overlap_save_filter_sharded_split(x, np.zeros_like(x), h, m["x"], "x")
    out["batched_x"], out["batched_h"] = x, h
    out["batched_y"] = host(gather(yr, m["x"], "x", -1))
    z = np.zeros(64, np.float32)
    out["short"] = raised(lambda: overlap_save_filter_sharded_split(
        z, z, np.zeros(65, np.float32), m["x"], "x"))
    return out


@case("split")
def filterbank_split(m):
    from fftlab_torch.dist import gather
    from fftlab_torch.dist.overlap_save_split import overlap_save_filterbank_sharded_split

    x, hb = f32(0, (4, 4096)), f32(1, (4, 31))
    y = overlap_save_filterbank_sharded_split(x, hb, m["dp_sp"])
    y = gather(gather(y, m["dp_sp"], "sp", -1), m["dp_sp"], "dp", 0)
    return {"x": x, "h": hb, "y": host(y)}


@case("split")
def filter_plan_mesh(m):
    from fftlab_torch.dist import gather
    from fftlab_torch.plan.filter_plan import FilterPlan

    out = {}
    for nh, n in ((129, 16384), (33, 8192)):
        x, x2, h = f32(70 + nh, n), f32(71 + nh, n), f32(72 + nh, nh)
        plan = FilterPlan(h, mesh=m["x"], time_axis="x")
        y = plan(x)
        yr, yi = plan(x, x2)
        out[f"x{nh}"], out[f"x2_{nh}"], out[f"h{nh}"] = x, x2, h
        out[f"y{nh}"] = host(gather(y, m["x"], "x", -1))
        out[f"pair{nh}"] = (host(gather(yr, m["x"], "x", -1))
                            + 1j * host(gather(yi, m["x"], "x", -1)))
        out[f"describe{nh}"] = np.asarray(plan.describe())
    return out


@case("split")
def fft2(m):
    from fftlab_torch.dist import fft2_sharded_split, gather

    xr, xi = f32(0, (64, 128)), f32(1, (64, 128))
    out = {"x": xr + 1j * xi}
    y1 = fft2_sharded_split(xr, xi, m["x"], "x")
    out["y"] = pair([gather(t, m["x"], "x", 0) for t in y1])
    for k in (2, 4):
        yk = fft2_sharded_split(xr, xi, m["x"], "x", chunks=k)
        out[f"equal{k}"] = np.asarray(all(torch.equal(a, b) for a, b in zip(y1, yk)))
    out["three"] = raised(lambda: fft2_sharded_split(xr, xi, m["x"], "x", chunks=3))
    tr = f32(2, (32, 64))
    yt = fft2_sharded_split(tr, np.zeros_like(tr), m["x"], "x", transposed_out=True)
    out["t_x"], out["t_y"] = tr, pair([gather(t, m["x"], "x", 0) for t in yt])
    ar, ai = f32(3, (32, 32)), f32(4, (32, 32))
    Y = [gather(t, m["x"], "x", 0) for t in fft2_sharded_split(ar, ai, m["x"], "x")]
    back = fft2_sharded_split(*Y, m["x"], "x", direction=1)
    out["rt_x"], out["rt_back"] = ar + 1j * ai, pair([gather(t, m["x"], "x", 0) for t in back])
    z = np.zeros((30, 64), np.float32)
    out["indivisible"] = raised(lambda: fft2_sharded_split(z, z, m["x"], "x"))
    return out


@case("split")
def mesh2d(m):
    from fftlab_torch.dist import fft2_sharded_split, gather
    from fftlab_torch.dist.fft2_mesh2d import fft2_mesh2d_split

    mesh = m["a_b"]
    x = c64(0, (64, 128))
    out = {"x": x, "y": pair(fft2_mesh2d_split(x.real.copy(), x.imag.copy(), mesh, "a", "b"))}
    ar, ai = f32(2, (32, 64)), f32(3, (32, 64))
    Y = fft2_mesh2d_split(ar, ai, mesh, "a", "b")
    out["rt_x"] = ar + 1j * ai
    out["rt_back"] = pair(fft2_mesh2d_split(*Y, mesh, "a", "b", direction=1))
    u = c64(3, (32, 64))
    wr, wi = fft2_mesh2d_split(u.real.copy(), u.imag.copy(), mesh, "a", "b", flatten=False)
    whole = lambda w: gather(gather(w, mesh, "a", -1), mesh, "b", 1)
    out["block_x"], out["block_shape"] = u, np.asarray(wr.shape)
    out["block_w"] = host(whole(wr)) + 1j * host(whole(wi))
    pr, pi = f32(5, (32, 64)), f32(6, (32, 64))
    out["pencil_x"] = pr + 1j * pi
    out["pencil_mesh2d"] = pair(fft2_mesh2d_split(pr, pi, mesh, "a", "b"))
    out["pencil_1d"] = pair([gather(t, m["x"], "x", 0)
                             for t in fft2_sharded_split(pr, pi, m["x"], "x")])
    z = np.zeros((30, 64), np.float32)
    out["indivisible"] = raised(lambda: fft2_mesh2d_split(z, z, mesh, "a", "b"))
    return out


@case("split")
def batch_axes(m):
    from fftlab_torch.dist import four_step_fft_sharded_split

    mesh = m["a_b"]
    xr = np.zeros((4, 64), np.float32)
    x3 = np.zeros((3, 64), np.float32)
    return {"twice": raised(lambda: four_step_fft_sharded_split(
                xr, xr, mesh, "b", batch_axes=("a", "a"))),
            "reuse": raised(lambda: four_step_fft_sharded_split(
                xr, xr, mesh, "b", batch_axes=("b",))),
            "indivisible": raised(lambda: four_step_fft_sharded_split(
                x3, x3, mesh, "b", batch_axes=("a",)))}


# ---------------------------------------------------------------------------
# suite "entry": tests/test_torch_entry.py (the multi-chip dry run)
# ---------------------------------------------------------------------------


def _dryrun(n_devices: int) -> dict:
    import torch.distributed as dist

    from fftlab_torch.entry import dryrun_multichip

    dryrun_multichip(n_devices, device_type="cpu")
    return {"n_devices": np.asarray(n_devices), "world": np.asarray(dist.get_world_size())}


@case("entry")
def dryrun_2(m):  # over the first two ranks of the world: dp 1, pp 2
    return _dryrun(2)


@case("entry")
def dryrun_4(m):  # dp 2 x sp 2, pp 4
    return _dryrun(4)


# ---------------------------------------------------------------------------
# suite "pipelines": tests/test_tp_pipeline.py and test_pp_pipeline.py
# ---------------------------------------------------------------------------


def _tp(m, xr, xi, hr, hi, **kw):
    from fftlab_torch.dist import tp_spectral_filter_split

    return tp_spectral_filter_split(xr, xi, hr, hi, m["tp"], **kw)


@case("pipelines")
def tp_matches_unsharded(m):
    n = 1 << 16
    xr, xi, hr, hi = f32(0, n), f32(100, n), f32(1, n), f32(101, n)
    return {"x": xr + 1j * xi, "h": hr + 1j * hi, "y": pair(_tp(m, xr, xi, hr, hi,
                                                                flatten=True))}


@case("pipelines")
def tp_identity(m):
    n = 1 << 14
    xr, xi = f32(3, n), f32(103, n)
    y = _tp(m, xr, xi, np.ones(n, np.float32), np.zeros(n, np.float32), flatten=True)
    return {"x": xr + 1j * xi, "y": pair(y)}


@case("pipelines")
def tp_block(m):
    from fftlab_torch.dist import gather

    n = 1 << 14
    xr, xi, hr, hi = f32(4, n), f32(104, n), f32(5, n), f32(105, n)
    yr, yi = _tp(m, xr, xi, hr, hi)
    return {"x": xr + 1j * xi, "h": hr + 1j * hi, "block_shape": np.asarray(yr.shape),
            "y": host(gather(yr, m["tp"], "tp", -1)) + 1j * host(gather(yi, m["tp"], "tp", -1))}


@case("pipelines")
def tp_chained(m):
    from fftlab_torch.dist import gather

    n = 1 << 14
    xr, xi, hr, hi = f32(6, n), f32(106, n), f32(7, n), f32(107, n)
    m1r, m1i = _tp(m, xr, xi, hr, hi)
    flat = lambda t: gather(t, m["tp"], "tp", -1).reshape(n)
    y2 = _tp(m, flat(m1r), flat(m1i), hr, hi, flatten=True)
    return {"x": xr + 1j * xi, "h": hr + 1j * hi, "y": pair(y2)}


@case("pipelines")
def tp_large(m):
    n = 1 << 20
    xr = f32(9, n)
    mask = np.zeros(n, np.float32)
    mask[: n // 64] = 1.0
    mask[-(n // 64) + 1:] = 1.0
    y = _tp(m, xr, np.zeros(n, np.float32), mask, np.zeros(n, np.float32), flatten=True)
    return {"x": xr, "h": mask, "y": pair(y)}


@case("pipelines")
def tp_indivisible(m):
    z = np.zeros(144, np.float32)
    return {"raises": raised(lambda: _tp(m, z, z, np.ones(144, np.float32), z))}


def _pp_data():
    B, n = 6, 256
    rng = np.random.default_rng(17)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, n), (B, n), n, n, n))


@case("pipelines")
def pp(m):
    from fftlab_torch.dist import pp_spectral_pipeline_split

    br, bi, hr, hi, w = _pp_data()
    out = {"br": br, "bi": bi, "hr": hr, "hi": hi, "w": w}
    for p in (1, 2, 4):
        if m[f"pp{p}"].get_coordinate() is not None:
            out[f"y{p}"] = pair(pp_spectral_pipeline_split(br, bi, hr, hi, m[f"pp{p}"],
                                                           axis_name="pp", window=w))
    mesh = m["pp4"]
    if mesh.get_coordinate() is not None:
        out["default_window"] = pair(pp_spectral_pipeline_split(br, bi, hr, hi, mesh))
        out["one_block"] = pair(pp_spectral_pipeline_split(br[:1], bi[:1], hr, hi, mesh,
                                                           window=w))
        out["blocks"] = raised(lambda: pp_spectral_pipeline_split(br[0], bi[0], hr, hi, mesh))
        out["window"] = raised(lambda: pp_spectral_pipeline_split(br, bi, hr, hi, mesh,
                                                                  window=w[:-1]))
        out["response"] = raised(lambda: pp_spectral_pipeline_split(br, bi, hr[:-1], hi[:-1],
                                                                    mesh))
    if m["pp3"].get_coordinate() is not None:
        out["divide"] = raised(lambda: pp_spectral_pipeline_split(br, bi, hr, hi, m["pp3"]))
    return out


# ---------------------------------------------------------------------------
# suite "multihost": tests/test_multihost.py (two processes, joined by
# multihost.ensure_initialized itself)
# ---------------------------------------------------------------------------


@case("multihost")
def two_process(m):
    from fftlab_torch.dist import gather, overlap_save_filter_sharded_split
    from fftlab_torch.dist import pp_spectral_pipeline_split
    from fftlab_torch.dist.multihost import host_local_mesh_axes, process_info

    mesh = m["sp"]
    n, nh = 4096, 33
    xr, xi, h = f32(7, n), f32(8, n), f32(9, nh)
    yr, yi = overlap_save_filter_sharded_split(xr, xi, h, mesh)
    B, nb = 5, 128
    br, bi, hr, hi = f32(10, (B, nb)), f32(11, (B, nb)), f32(12, nb), f32(13, nb)
    pr, pi = pp_spectral_pipeline_split(br, bi, hr, hi, mesh, axis_name="sp")
    info = process_info()
    return {"process_count": np.asarray(info["process_count"]),
            "global_devices": np.asarray(info["global_devices"]),
            "axes": np.asarray([host_local_mesh_axes()["dp"], host_local_mesh_axes()["sp"]]),
            "x": xr + 1j * xi, "h": h,
            "block_shape": np.asarray(yr.shape),
            "y": host(gather(yr, mesh, "sp", -1)) + 1j * host(gather(yi, mesh, "sp", -1)),
            "b": br + 1j * bi, "H": hr + 1j * hi, "pp": pair((pr, pi))}


# ---------------------------------------------------------------------------


def meshes(suite: str, world: int) -> dict:
    """Every mesh of the suite, built on every rank in the same order."""
    from fftlab_torch.dist import make_mesh, make_mesh_1d

    cpu = dict(device_type="cpu")
    if suite == "entry":  # dryrun_multichip builds its own
        return {}
    if suite == "multihost":
        return {"sp": make_mesh_1d("sp", **cpu)}
    if suite == "pipelines":
        out = {"tp": make_mesh_1d("tp", **cpu)}
        for p in (1, 2, 3, 4):
            out[f"pp{p}"] = make_mesh({"pp": p}, **cpu)
        return out
    out = {"x": make_mesh_1d("x", **cpu),
           "dp_sp": make_mesh({"dp": 2, "sp": world // 2}, **cpu)}
    if suite == "split":
        out["a_b"] = make_mesh((2, world // 2), ("a", "b"), **cpu)
    return out


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_env() -> dict:
    """The environment of a rank process: the repo importable, one thread,
    no card, and no torchrun variables of the caller's."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


def run_ranks(suite: str, world: int, tmp_dir, timeout_s: float = 300) -> dict:
    """Start `world` ranks of this file on `suite` and return rank 0's
    results as {"<case>/<name>": array}. Raises RuntimeError, with the
    ranks' output, if a rank fails or the ranks outlast `timeout_s`
    (then they are killed)."""
    tmp_dir = os.fspath(tmp_dir)
    root, env = ROOT, rank_env()
    init, out = os.path.join(tmp_dir, "init"), os.path.join(tmp_dir, f"{suite}.npz")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), init, out],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout_s)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{suite} ranks outlasted {timeout_s} s and were killed")
    bad = [(r, p.returncode, t) for r, (p, t) in enumerate(zip(procs, texts)) if p.returncode]
    if bad:
        raise RuntimeError("\n".join(f"rank {r} exited {rc}:\n{t}" for r, rc, t in bad))
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def main() -> int:
    suite, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    # a caller's reduced matmul precision (bfloat16 on this CPU where it
    # can): every contraction of the port must pin full float32 itself
    # (fftlab_torch/core/precision.py), or the gates fail
    torch.set_float32_matmul_precision("medium")
    from fftlab_torch.dist.multihost import ensure_initialized

    if not ensure_initialized(f"file://{init}", world, rank, backend="gloo",
                              device_type="cpu", timeout_s=TIMEOUT_S):
        raise RuntimeError("ensure_initialized joined no process group")
    m = meshes(suite, world)
    results = {}
    for fn in SUITES[suite]:
        try:
            res = fn(m)
        except Exception:  # recorded for the case's test, and the next case runs
            res = {"error": np.asarray(traceback.format_exc())}
        results.update({f"{fn.__name__}/{k}": np.asarray(v) for k, v in res.items()})
    import torch.distributed as dist

    dist.barrier()
    if rank == 0:
        np.savez(out + ".part.npz", **results)
        os.replace(out + ".part.npz", out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
