"""Multi-rank demo: the sharded pipelines over a mesh of ranks, each
checked against its single-device counterpart (counterpart of
fftlab/cli/dist_demo.py).

Runs the DP x SP overlap-save filterbank, the TP four-step FFT, the
segment-sharded Welch PSD, the 2-D FFT over both axes of a 2-D mesh and
the PP pipeline:

    python -m fftlab_torch.cli.dist_demo --ranks P [--backend gloo] [--device cuda|cpu]

starts P ranks itself (torch.multiprocessing), or, under torchrun, joins
the world torchrun gives (`torchrun --nproc-per-node P -m
fftlab_torch.cli.dist_demo`). The ranks run on the card unless
`--device cpu` is given, and raise without one. NCCL takes one rank per
card: P ranks on fewer cards need `--backend gloo`, or the demo raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def demo(device_type: str, backend: str | None) -> None:
    """Every rank runs this; rank 0 prints."""
    import torch
    import torch.distributed as dist

    from fftlab_torch.algos.split_stockham import spectral_filter_split
    from fftlab_torch.dist import (four_step_fft, four_step_fft_sharded, gather, make_mesh,
                                   make_mesh_1d, welch_psd_sharded)
    from fftlab_torch.dist.fft2_mesh2d import fft2_mesh2d_split
    from fftlab_torch.dist.mesh import mesh_device
    from fftlab_torch.dist.overlap_save import overlap_save_filterbank_sharded
    from fftlab_torch.dist.pp_pipeline import pp_spectral_pipeline_split
    from fftlab_torch.dsp.spectrum import welch_psd

    kw = dict(device_type=device_type, backend=backend)
    mesh1 = make_mesh_1d("tp", **kw)
    p = mesh1["tp"].size()
    dev = mesh_device(mesh1)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"{p} device(s): {dev.type} ({dist.get_backend()})")
    rng = np.random.default_rng(0)
    host = lambda t: t.detach().cpu().numpy()

    if p < 2:
        say("single device — sharded pipelines need >= 2 (--ranks)")
        return
    dp = 2 if p % 2 == 0 else 1
    sp = p // dp
    mesh = make_mesh({"dp": dp, "sp": sp}, **kw)
    c, n, nh = 2 * dp, 1024 * sp, 33
    x = rng.standard_normal((c, n)).astype(np.float32)
    hb = rng.standard_normal((c, nh)).astype(np.float32)
    y = overlap_save_filterbank_sharded(x, hb, mesh)
    y = host(gather(gather(y, mesh, "sp", -1), mesh, "dp", 0))
    err = max(float(np.max(np.abs(y[ch] - np.convolve(x[ch].astype(np.float64),
                                                       hb[ch])[:n])))
              for ch in range(c))
    say(f"overlap-save filterbank on (dp={dp}, sp={sp}): "
        f"{c} channels x {n} samples, max err {err:.2e}")

    m = 16 * p
    big = (rng.standard_normal(m * m) + 1j * rng.standard_normal(m * m)).astype(np.complex64)
    X = host(four_step_fft_sharded(big, mesh1, "tp", n1=m))
    err = float(np.max(np.abs(X - host(four_step_fft(torch.from_numpy(big).to(dev))))))
    say(f"four-step {m * m}-pt FFT over tp={p} (all_to_all): "
        f"max err vs single-device {err:.2e}")

    sig = rng.standard_normal(2048 * p).astype(np.float32)
    _, psd_s = welch_psd_sharded(sig, mesh1, "tp", window_size=256)
    _, psd_1 = welch_psd(torch.from_numpy(sig).to(dev), window_size=256)
    err = float(np.max(np.abs(host(psd_s) - host(psd_1))))
    say(f"sharded Welch PSD (psum averaging): max err {err:.2e}")

    if dp > 1:
        R2, C2 = 16 * dp, 32 * sp * sp
        img = rng.standard_normal((R2, C2)).astype(np.float32)
        fr, fi = fft2_mesh2d_split(img, np.zeros_like(img), mesh, "dp", "sp",
                                   r1=4 * dp, c1=4 * sp)
        err = float(np.max(np.abs(host(fr) + 1j * host(fi) - np.fft.fft2(img))))
        say(f"2D-mesh 2D FFT ({R2}x{C2} over dp x sp, both axes "
            f"four-step): max err vs numpy {err:.2e}")

    pp = 4 if p >= 4 else 2
    mesh_pp = make_mesh({"pp": pp}, devices=range(pp), **kw)
    B, nb = 8, 512
    br = rng.standard_normal((B, nb)).astype(np.float32)
    hr = rng.standard_normal(nb).astype(np.float32)
    zi = np.zeros(nb, np.float32)
    if mesh_pp.get_coordinate() is not None:
        yr, _ = pp_spectral_pipeline_split(br, np.zeros_like(br), hr, zi, mesh_pp, "pp")
        b = torch.from_numpy(br).to(dev)
        wr, _ = spectral_filter_split(b, torch.zeros_like(b), torch.from_numpy(hr).to(dev),
                                      torch.from_numpy(zi).to(dev))
        err = float(np.max(np.abs(host(yr) - host(wr))))
        say(f"PP pipeline ({pp} stages, {B} blocks, {B + pp - 1} "
            f"ticks): max err vs unsharded {err:.2e}")


def _run(device_type: str, backend: str | None, *world) -> None:
    """Join the world (`world`: an init URL, its size and this rank, or
    torchrun's environment), run the demo, leave the world."""
    import torch.distributed as dist

    from fftlab_torch.dist.multihost import ensure_initialized

    ensure_initialized(*world, backend=backend, device_type=device_type)
    try:
        demo(device_type, backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank(rank: int, world: int, init: str, device_type: str, backend: str | None) -> None:
    """One spawned rank: the world is the file store `init`."""
    _run(device_type, backend, f"file://{init}", world, rank)


def main(argv: list[str] | None = None) -> None:
    from fftlab_torch.cli import parse
    from fftlab_torch.dist.multihost import check_backend, default_backend

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: one per card, 8 on the CPU); "
                         "under torchrun its world")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default NCCL on the card, gloo on the CPU")
    args = parse(ap, argv)
    device_type = args.device.type
    if "WORLD_SIZE" in os.environ:  # torchrun started this rank
        _run(device_type, args.backend)
        return
    import torch
    import torch.multiprocessing as mp

    world = args.ranks or (torch.cuda.device_count() if device_type == "cuda" else 8)
    check_backend(args.backend or default_backend(device_type), device_type, world)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, os.path.join(tmp, "init"), device_type, args.backend),
                 nprocs=world, join=True)


if __name__ == "__main__":
    main()
