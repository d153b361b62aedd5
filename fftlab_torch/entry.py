"""The repo's entry points on the port (counterpart of
__graft_entry__.py):

- `entry()` returns the flagship single-card forward: 8 x 16384 split
  planes through the FFT -> H -> IFFT sandwich of the tensor-op
  Stockham (`algos/split_stockham.spectral_filter_split`), on the card.
- `dryrun_multichip(n_devices)` runs one step of every sharded path of
  `fftlab_torch.dist` at tiny shapes over the first `n_devices` ranks
  of the world: the dp x sp filterbank, the complex four-step, the
  sharded STFT and Welch, the split four-step (chunks 1 and 2), the
  split overlap-save (held against a mesh of one rank), the 2-D mesh
  FFT where dp > 1, and the TP and PP pipelines. It is SPMD: every rank
  of the world calls it (`dist/mesh.py` states the contract).

    python -m fftlab_torch.entry [--device cpu]

runs both, on a world of one rank, or under torchrun
(`torchrun --nproc-per-node P -m fftlab_torch.entry`) on torchrun's
world, one rank per card (or `--device cpu`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args) for the flagship single-card forward step:
    ifft(fft(x) * H), 1/n scaled, on 8 x 16384 split planes, all on
    `device` (the card by default)."""
    from fftlab_torch.algos.split_stockham import spectral_filter_split
    from fftlab_torch.core.types import require_device

    dev = require_device(device)
    n, batch = 16384, 8
    xr = torch.ones((batch, n), dtype=torch.float32, device=dev)
    xi = torch.zeros((batch, n), dtype=torch.float32, device=dev)
    hr = torch.ones((n,), dtype=torch.float32, device=dev)
    hi = torch.zeros((n,), dtype=torch.float32, device=dev)

    def forward(xr, xi, hr, hi):
        return spectral_filter_split(xr, xi, hr, hi)

    return forward, (xr, xi, hr, hi)


def dryrun_multichip(n_devices: int, *, device_type: str = "cuda",
                     backend: str | None = None) -> None:
    """One step of every sharded path on tiny shapes over the first
    `n_devices` ranks of the world (dp x sp, plus tp over all of them),
    on `device_type` with `backend` (NCCL on the card, gloo on the CPU,
    by default). Every rank of the world calls it. Raises if the world
    has fewer ranks, and if the split overlap-save over the mesh and
    over a mesh of one rank differ by more than 1e-5."""
    import torch.distributed as dist

    from fftlab_torch.dist import (four_step_fft_sharded, four_step_fft_sharded_split,
                                   gather, make_mesh, make_mesh_1d,
                                   overlap_save_filter_sharded_split,
                                   pp_spectral_pipeline_split, stft_sharded,
                                   tp_spectral_filter_split, welch_psd_sharded)
    from fftlab_torch.dist.fft2_mesh2d import fft2_mesh2d_split
    from fftlab_torch.dist.overlap_save import overlap_save_filterbank_sharded

    kw = dict(device_type=device_type, backend=backend)
    mesh_one = make_mesh_1d("tp", devices=[0], **kw)  # joins the world
    world = dist.get_world_size()
    if world < n_devices:
        raise ValueError(f"need {n_devices} ranks, the world has {world}")
    mesh1d = make_mesh_1d("tp", devices=range(n_devices), **kw)
    dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    sp = n_devices // dp
    mesh2d = make_mesh({"dp": dp, "sp": sp}, **kw)
    pp = 4 if n_devices >= 4 else (2 if n_devices >= 2 else 1)
    mesh_pp = make_mesh({"pp": pp}, **kw)
    if mesh1d.get_coordinate() is None:  # a rank past n_devices built the meshes
        return

    rng = np.random.default_rng(0)
    channels, nh = 2 * dp, 9
    n = 512 * sp
    x = rng.standard_normal((channels, n)).astype(np.float32)
    h_bank = rng.standard_normal((channels, nh)).astype(np.float32)

    # DP x SP: channel- and time-sharded overlap-save filterbank
    y = overlap_save_filterbank_sharded(x, h_bank, mesh2d, "dp", "sp")
    if tuple(y.shape) != (channels // dp, n // sp):
        raise ValueError(f"the filterbank's block is {tuple(y.shape)}")

    # TP: the complex four-step with its all_to_all; SP: the frame-sharded
    # STFT; DP: the segment-sharded Welch with its psum
    sig = rng.standard_normal(1024 * n_devices).astype(np.float32)
    m = max(16 * n_devices, 64)
    big = (rng.standard_normal(m * m) + 1j * rng.standard_normal(m * m)).astype(np.complex64)
    X = four_step_fft_sharded(big, mesh1d, axis_name="tp", n1=m)
    if tuple(X.shape) != (m * m,):
        raise ValueError(f"the four-step returned {tuple(X.shape)}")
    stft_sharded(sig, mesh1d, "tp", fft_size=256, hop=128)
    welch_psd_sharded(sig, mesh1d, "tp", window_size=128)

    # the split-plane paths: the four-step, whole and in two slabs, and
    # the overlap-save with its halo exchange
    m2 = max(8 * n_devices, 32)
    br = rng.standard_normal(m2 * m2).astype(np.float32)
    bi = rng.standard_normal(m2 * m2).astype(np.float32)
    four_step_fft_sharded_split(br, bi, mesh1d, "tp", n1=m2)
    four_step_fft_sharded_split(br, bi, mesh1d, "tp", n1=m2, chunks=2)
    taps = rng.standard_normal(9).astype(np.float32)
    zeros = np.zeros_like(sig)
    fr, fi = (gather(t, mesh1d, "tp", -1)
              for t in overlap_save_filter_sharded_split(sig, zeros, taps, mesh1d, "tp"))

    # the halo exchange adds mechanics, never drift: the pipeline over the
    # mesh equals the one on a mesh of one rank
    if mesh_one.get_coordinate() is not None:
        one_r, one_i = overlap_save_filter_sharded_split(sig, zeros, taps, mesh_one, "tp")
        np.testing.assert_allclose(fr.cpu().numpy(), one_r.cpu().numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(fi.cpu().numpy(), one_i.cpu().numpy(), atol=1e-5, rtol=1e-5)

    # the 2-D FFT over both axes of the mesh (rows over dp, each 1-D pass a
    # four-step over sp), with factors every axis size divides
    if dp > 1:
        R2d, C2d = 16 * dp, 32 * sp * sp
        img = rng.standard_normal((R2d, C2d)).astype(np.float32)
        fr2, _ = fft2_mesh2d_split(img, np.zeros_like(img), mesh2d, "dp", "sp",
                                   r1=4 * dp, c1=4 * sp)
        if fr2.ndim != 2:
            raise ValueError(f"the 2-D mesh FFT returned {tuple(fr2.shape)}")

    # TP: four-step -> sharded pointwise -> inverse with no gather
    hones = np.ones(m2 * m2, np.float32)
    tp_spectral_filter_split(br, bi, hones, np.zeros_like(hones), mesh1d, "tp")

    # PP: window/FFT/xH/IFFT stages, one a rank, blocks passed along
    if mesh_pp.get_coordinate() is not None:
        nb = 128
        blocks = rng.standard_normal((3, nb)).astype(np.float32)
        pp_spectral_pipeline_split(blocks, np.zeros_like(blocks), np.ones(nb, np.float32),
                                   np.zeros(nb, np.float32), mesh_pp, "pp")


def main(argv: list[str] | None = None) -> None:
    import os

    import torch.distributed as dist

    from fftlab_torch.cli import parse
    from fftlab_torch.dist.multihost import ensure_initialized

    args = parse(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]), argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry OK:", [tuple(t.shape) for t in out])
    world = int(os.environ.get("WORLD_SIZE", "1"))
    ensure_initialized(device_type=args.device.type)  # torchrun's world, if any
    try:
        dryrun_multichip(world, device_type=args.device.type)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"dryrun_multichip({world}) OK")


if __name__ == "__main__":
    main()
