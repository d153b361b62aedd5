"""The process group the meshes run on (counterpart of
fftlab/dist/multihost.py:22-67).

The JAX package runs one controller per host over `jax.distributed`;
the port runs one process per rank over `torch.distributed`, each rank
driving one device: `cuda:(LOCAL_RANK % device_count)` on a card, or the
CPU. `ensure_initialized` joins the world torchrun describes
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or the one its
arguments name, and is a no-op for one process, so code can call it
unconditionally.

Backends: NCCL on the card, gloo on the CPU. NCCL takes one rank per
card; where ranks outnumber the cards of a host, the caller must name
`backend="gloo"` (gloo runs CUDA tensors too), or the call raises. The
backend is never switched behind the caller's back.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# how long a collective waits for its peers by default before it raises
TIMEOUT_S = 300


def default_backend(device_type: str) -> str:
    """NCCL for a CUDA mesh, gloo for a CPU one."""
    return "nccl" if device_type == "cuda" else "gloo"


def _ranks_here(world: int) -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun sets it), else all."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def check_backend(backend: str, device_type: str, world: int) -> None:
    """Refuse a backend that cannot run the mesh: NCCL with more ranks on
    this host than cards (two ranks on one card are a "duplicate GPU"
    error inside NCCL), or NCCL on the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    if backend != "nccl":
        return
    if device_type == "cpu":
        raise ValueError("NCCL runs CUDA tensors only; a CPU mesh takes backend='gloo'")
    cards, here = torch.cuda.device_count(), _ranks_here(world)
    if here > cards:
        raise RuntimeError(
            f"{here} ranks on {cards} card(s): NCCL takes one rank per card; pass "
            f"backend='gloo' to share a card among ranks")


def pin_device(device_type: str, rank: int) -> torch.device:
    """The device of global rank `rank`: the card LOCAL_RANK %
    device_count (made the current one; LOCAL_RANK is torchrun's, else the
    rank, every rank on one host), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card and none is available; pass "
                           'device_type="cpu" to run on the CPU')
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def ensure_initialized(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None, *,
                       backend: str | None = None,
                       device_type: str = "cuda",
                       timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group when running multi-process; a no-op for one
    process. Returns True if a process group is active.

    From torchrun's environment (MASTER_ADDR/MASTER_PORT, WORLD_SIZE,
    RANK) or explicit arguments: `coordinator_address` is "host:port"
    (TCP) or an init URL ("file:///path", "tcp://host:port").
    `backend` defaults to NCCL for `device_type="cuda"`, gloo for "cpu";
    a collective that waits `timeout_s` for its peers raises.
    """
    if dist.is_initialized():
        return True
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    nproc = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    if addr is None or nproc <= 1:
        return False  # one process: nothing to join
    pid = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, nproc)
    pin_device(device_type, pid)
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=nproc, rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def host_local_mesh_axes() -> dict:
    """Recommended axis layout: the halo-exchange axis ('sp') innermost
    over the ranks of one host (NVLink), DP across hosts."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    n_local = max(_ranks_here(world), 1)
    return {"dp": max(world // n_local, 1), "sp": n_local}


def process_info() -> dict:
    """This rank's place in the world. Each rank drives one device, so a
    process has one local device and the world as many as it has ranks."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
