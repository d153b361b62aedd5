"""The collectives of the distributed layer: the port's counterparts of
the `lax` collectives the JAX package's `shard_map` bodies use, written
once for NCCL and gloo.

- `all_to_all`  `lax.all_to_all(..., tiled=True)`: split a dim into one
                chunk per rank, send chunk d to rank d, concatenate what
                arrives along another dim in rank order;
- `shift`       `lax.ppermute` over the open chain (i -> i + 1 or
                i -> i - 1): a rank that receives nothing gets zeros;
- `psum`        `lax.psum`, as `all_reduce`;
- `gather`      the blocks of every rank concatenated along a dim (where
                the JAX package reshards to replicated);
- `broadcast`   one rank's tensor on every rank of the group.

Ranks are group ranks, the order of the mesh axis. A complex tensor
travels as its float pairs (`torch.view_as_real`). Each collective is
PyTorch's own on either backend. gloo runs the four they use
(all_to_all_single, all_reduce, broadcast, all_gather) on CUDA tensors
by copying them through host memory (chip_smoke.py phase 4h (b) runs
every collective here over four gloo ranks sharing one card).
PyTorch's backend table lists send/recv on CUDA tensors as unsupported
for gloo, which is why `shift` is an all_to_all. `STAGED["bytes"]`
counts the bytes of CUDA tensors handed to gloo, the traffic that goes
through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# bytes of CUDA tensors handed to gloo collectives since the count was last reset
STAGED = {"bytes": 0}


def _count(x: torch.Tensor, group) -> torch.Tensor:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        STAGED["bytes"] += x.numel() * x.element_size()
    return x


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (the float pairs of a complex x, or a real tensor) as x's dtype."""
    return torch.view_as_complex(y.contiguous()) if x.is_complex() else y


class Pending:
    """An asynchronous `all_to_all`: `wait()` returns its result."""

    def __init__(self, work, finish):
        self._work, self._finish = work, finish

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._finish()


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int,
               async_op: bool = False):
    """`lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)` over `group`: the result has x's shape with split_dim
    divided and concat_dim multiplied by the group size. With `async_op`
    a `Pending` comes back, and the collective runs beside what the
    caller enqueues next."""
    p = dist.get_world_size(group)
    nd = x.ndim
    s, c = split_dim % nd, concat_dim % nd
    size = int(x.shape[s])
    if size % p:
        raise ValueError(f"all_to_all: dim {s} of size {size} does not split over {p} ranks")
    # chunk d = x's slice d of the split dim; only the chunk index moves to
    # the front, so each chunk keeps its layout and a leading chunk index
    # (p = 1, or a split of the first dim) needs no copy
    send = _count(_real(x).unflatten(s, (p, size // p)).movedim(s, 0).contiguous(), group)
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish():
        # recv[d]: rank d's chunk for this rank, concatenated along c
        return _like(recv.movedim(0, c).flatten(c, c + 1), x)

    return Pending(work, finish) if async_op else finish()


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send x to group rank i + step and return what rank i - step sent;
    the rank with no sender in the open chain gets zeros (`step` +1: rank
    0; -1: the last rank). One `all_to_all` whose chunks are empty but
    the one to the neighbour."""
    if step not in (1, -1):
        raise ValueError(f"shift takes step +1 or -1; got {step}")
    p = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    dst, src = i + step, i - step
    if p == 1:
        return torch.zeros_like(x)
    flat = _count(_real(x).reshape(-1).contiguous(), group)
    k = flat.numel()
    send_sizes, recv_sizes = [0] * p, [0] * p
    sends = 0 <= dst < p
    if sends:
        send_sizes[dst] = k
    if 0 <= src < p:
        recv_sizes[src] = k
    recv = flat.new_empty(sum(recv_sizes))
    dist.all_to_all_single(recv, flat if sends else flat[:0], recv_sizes, send_sizes,
                           group=group)
    if not recv.numel():
        return torch.zeros_like(x)
    return _like(recv.reshape(_real(x).shape), x)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, on every rank."""
    y = _count(_real(x).clone(), group)
    dist.all_reduce(y, group=group)
    return _like(y, x)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank `src`'s x on every rank (x gives the shape and dtype)."""
    y = _count(_real(x).contiguous().clone(), group)
    dist.broadcast(y, dist.get_global_rank(group, src), group=group)
    return _like(y, x)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in group-rank order, on
    every rank."""
    p = dist.get_world_size(group)
    y = _count(_real(x).contiguous(), group)
    parts = [torch.empty_like(y) for _ in range(p)]
    dist.all_gather(parts, y, group=group)
    return _like(torch.cat(parts, dim=dim % x.ndim), x)
