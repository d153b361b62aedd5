"""A feature tour: the planner's algorithm choice over mixed sizes, the
plan API, the split plans and their routes, the hardware report, and the
teaching visualizers (butterfly diagram, recursion tree, memory access
by stage, and the TPU tile-touch model)."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fftlab_torch import fft, plan_dft_1d
from fftlab_torch.algos.recursive import print_recursion_tree
from fftlab_torch.cli import parse
from fftlab_torch.plan.api import plan_c2r_1d_split, plan_dft_1d_split, plan_r2c_1d_split
from fftlab_torch.plan.flags import PlanConfig
from fftlab_torch.plan.hardware import detect_hardware
from fftlab_torch.plan.planner import estimate_algorithm, reference_heuristic
from fftlab_torch.utils.signals import generate_complex_noise
from fftlab_torch.utils.viz import butterfly_diagram, memory_access_trace, simulate_tile_touches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    args = parse(ap)
    dev = args.device

    print("=== fftlab_torch feature tour ===\n")
    print(detect_hardware().summary())

    print("\nAuto-selection:")
    cfg = PlanConfig()
    for n in (64, 256, 1024, 4096, 16384, 97, 360, 1000):
        algo = estimate_algorithm(n, cfg)
        ref = reference_heuristic(n)
        x = generate_complex_noise(n)
        X = fft(torch.from_numpy(x).to(dev))
        err = float(np.max(np.abs(X.cpu().numpy() - np.fft.fft(x))))
        print(f"  n={n:<7} fftlab->{algo:<14} (C reference would pick "
              f"{ref:<12}) max err vs numpy: {err:.2e}")

    print("\nPlan API (plan once, execute many):")
    plan = plan_dft_1d(1024, device=dev)
    print(f"  {plan.describe()}")
    x = generate_complex_noise(1024, batch=(4,))
    X = plan.execute(torch.from_numpy(x.astype(np.complex64)).to(dev))
    print(f"  executed batch {x.shape} -> {tuple(X.shape)} on {X.device.type}")

    print("\nSplit plan (route pinned at plan time):")
    sp = plan_dft_1d_split(1 << 16, device=dev)
    print(f"  {sp.describe()}")
    xr = torch.from_numpy(np.real(x).astype(np.float32)).to(dev)
    xi = torch.from_numpy(np.imag(x).astype(np.float32)).to(dev)
    sp1k = plan_dft_1d_split(1024, device=dev)
    sp1k.execute((xr, xi))
    print(f"  executed split batch {tuple(xr.shape)} via route "
          f"'{sp1k.algorithm}'; Flags.MEASURE would time every route "
          f"on the device and persist the winner as wisdom")
    pr = plan_r2c_1d_split(1 << 16, device=dev)
    pc = plan_c2r_1d_split(1 << 16, device=dev)
    print(f"  real plans (pack-two-reals through the same routes): "
          f"{pr.algorithm} / {pc.algorithm}")

    print("\nButterfly diagram, n=8:")
    print(butterfly_diagram(8))
    print("\nRecursion tree, n=16:")
    print_recursion_tree(16)
    print("\nMemory access by stage (annotated for the TPU's (8, 128) tile):")
    print(memory_access_trace(1 << 14))
    t = simulate_tile_touches(1 << 20)
    print(f"\nTPU VMEM-tile touch model (the TPU's (8, 128) tile, not the H100) at "
          f"n=2^20: DIT {t['dit_tile_touches']} vs Stockham "
          f"{t['stockham_tile_touches']} ({t['ratio']:.2f}x) — why the JAX "
          f"package's TPU path is Stockham")


if __name__ == "__main__":
    main()
