"""Meshes of ranks, and each rank's block (counterpart of
fftlab/dist/mesh.py:22-61).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims:
`mesh[axis].size()` stands where the JAX package reads
`mesh.shape[axis]`, `mesh.get_local_rank(axis)` is this rank's place on
the axis and `mesh.get_group(axis)` the group its collectives run on.
The axis names of the package:

- ``"dp"``  batch / channel sharding (pure data parallel)
- ``"sp"``  sequence (time-block) sharding for overlap-save/STFT
- ``"tp"``  intra-transform sharding for the four-step FFT

The contract of every function of `fftlab_torch.dist` (SPMD, one process
per rank, where the JAX package has one controller over `shard_map`):
every rank of the mesh calls it with the same whole input, as the JAX
functions take an unsharded array, and takes its own block of it. Where
the JAX result is replicated, every rank returns the whole output; where
it stays sharded, the rank returns its block, and `gather` rebuilds the
whole. Building a mesh is itself collective: every rank of the world
builds the same meshes in the same order, a rank outside a mesh too.

Meshes run on the card by default (`device_type="cuda"`, NCCL), or on
the CPU (`device_type="cpu"`, gloo); see `multihost` for the backends.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fftlab_torch.dist import comm
from fftlab_torch.dist.multihost import (check_backend, default_backend,
                                         ensure_initialized, pin_device)


def _join(device_type: str, backend: str | None) -> int:
    """Join the world (torchrun's, or a world of one over an in-process
    store), refuse a backend that cannot run the mesh, pin the device;
    the world's size."""
    if not dist.is_initialized() and not ensure_initialized(
            backend=backend, device_type=device_type):
        one = backend or default_backend(device_type)
        check_backend(one, device_type, 1)
        pin_device(device_type, 0)
        dist.init_process_group(one, store=dist.HashStore(), rank=0, world_size=1)
    actual = dist.get_backend()
    if backend is not None and actual != backend:
        raise ValueError(f"the process group runs {actual!r}, not backend={backend!r}")
    check_backend(actual, device_type, dist.get_world_size())
    pin_device(device_type, dist.get_rank())
    return dist.get_world_size()


def make_mesh_1d(axis_name: str = "x", devices=None, *, device_type: str = "cuda",
                 backend: str | None = None) -> DeviceMesh:
    """A 1D mesh over every rank of the world, or the global ranks
    `devices`."""
    world = _join(device_type, backend)
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, torch.tensor(ranks), mesh_dim_names=(axis_name,))


def make_mesh(shape: dict[str, int] | tuple, axis_names=None, devices=None, *,
              device_type: str = "cuda", backend: str | None = None) -> DeviceMesh:
    """A named mesh, e.g. ``make_mesh({"dp": 2, "sp": 4})``, over the first
    ranks of the world (or of the global ranks `devices`)."""
    if isinstance(shape, dict):
        axis_names = tuple(shape.keys())
        dims = tuple(shape.values())
    else:
        if axis_names is None:
            raise ValueError(
                "make_mesh with a tuple shape needs axis_names; or pass "
                'a dict like make_mesh({"dp": 2, "sp": 4})'
            )
        dims = tuple(shape)
        axis_names = tuple(axis_names)
    world = _join(device_type, backend)
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = math.prod(dims)
    if n > len(ranks):
        raise ValueError(f"mesh {dims} needs {n} devices, have {len(ranks)}")
    return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(dims),
                      mesh_dim_names=axis_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis(mesh: DeviceMesh, axis_name: str):
    """(size, this rank's index, group) of one mesh axis."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not part of the mesh {mesh}")
    return (mesh[axis_name].size(), mesh.get_local_rank(axis_name),
            mesh.get_group(axis_name))


def on_mesh(x, mesh: DeviceMesh) -> torch.Tensor:
    """x (a tensor, numpy or a list) as a tensor on this rank's device."""
    return torch.as_tensor(x, device=mesh_device(mesh))


def block(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, dim: int) -> torch.Tensor:
    """This rank's contiguous block of `x` along `dim`, split over
    `mesh[axis_name]`."""
    p, idx, _ = axis(mesh, axis_name)
    size = int(x.shape[dim])
    if size % p:
        raise ValueError(f"mesh axis {axis_name}={p} must divide dim {dim} of size {size}")
    step = size // p
    return x.narrow(dim, idx * step, step).contiguous()


def shard_batch(x, mesh: DeviceMesh, axis_name: str = "x", batch_axis: int = 0):
    """This rank's block of `x` with its batch axis split over
    `axis_name` (pure DP), on this rank's device."""
    return block(on_mesh(x, mesh), mesh, axis_name, batch_axis)


def replicate(x, mesh: DeviceMesh) -> torch.Tensor:
    """`x` on this rank's device, equal on every rank of the mesh: the
    first rank's copy, broadcast along each mesh axis in turn."""
    t = on_mesh(x, mesh).clone()
    for name in mesh.mesh_dim_names:
        t = comm.broadcast(t, mesh.get_group(name), 0)
    return t


def gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, dim: int) -> torch.Tensor:
    """The blocks of `mesh[axis_name]` concatenated along `dim` in rank
    order: the whole array where each rank holds one block."""
    return comm.gather(x, axis(mesh, axis_name)[2], dim)
