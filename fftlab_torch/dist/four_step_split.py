"""Four-step sharded FFT on split re/im planes (counterpart of
fftlab/dist/four_step_split.py:47-192): the math and collectives of
`four_step.four_step_fft_sharded` with every complex value carried as
two float32 planes, and the local transforms on the kernels.

Each rank runs its local FFTs through `local_fft`: the row kernel
`fft_rows` (K3) where `fft_vmem.supported_size(n)` holds (1024..16384),
and the route `select_split_impl` names otherwise (the two-pass pair at
2^15..2^21); on CPU tensors their plain versions. The forward is
unscaled and the inverse 1/n of each local pass, so the two passes of an
inverse give the transform's 1/n with no extra multiply.
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, Direction
from fftlab_torch.dist import comm
from fftlab_torch.dist.four_step import split_n, twiddle_cs
from fftlab_torch.dist.mesh import axis, block, gather, on_mesh
from fftlab_torch.kernels._common import check_planes, rows_of
from fftlab_torch.kernels.fft_vmem import fft_split_rows, supported_size
from fftlab_torch.plan.dispatch import run_route, select_split_impl


def local_fft(xr: torch.Tensor, xi: torch.Tensor, direction):
    """One rank's split-plane FFT of the rows [..., n]: `fft_rows` where
    the row kernel takes n, else the route `select_split_impl` picks."""
    xr, xi = xr.contiguous(), xi.contiguous()
    n = int(xr.shape[-1])
    if supported_size(n):
        return fft_split_rows(xr, xi, direction)
    return run_route(select_split_impl(n, rows_of(xr.shape)), xr, xi, direction)


def _swap(xr: torch.Tensor, xi: torch.Tensor):
    return xr.transpose(-1, -2).contiguous(), xi.transpose(-1, -2).contiguous()


def _rows_alone(n: int, rows: int, device: torch.device) -> bool:
    """True where `local_fft` launches a kernel (`fft_rows`, the pass
    pair, the three passes), which transforms every row on its own: then
    an FFT of a slab of rows gives the same bits as the FFT of all rows.
    The tensor-op route and the plain versions are batched matmuls, which
    may round a row differently at another batch size."""
    return device.type == "cuda" and (supported_size(n)
                                      or select_split_impl(n, rows) != "einsum")


def exchange_slabs(xr: torch.Tensor, xi: torch.Tensor, direction: Direction, p: int,
                   group, chunks: int = 1, twiddle=None):
    """FFT the rows of [..., rows, L] and exchange them: each rank sends
    column block d of its rows to rank d, and gets [..., rows*p, L/p],
    its column block of every rank's rows in rank order. `twiddle(row0,
    k)`, if given, returns the (cos, sin) planes each slab of k rows from
    row0 is multiplied by between the FFT and the exchange.

    `chunks` = K runs this in K slabs of rows; each slab's all_to_all is
    issued asynchronously, so it runs beside the next slab's work, and
    the slabs are restacked in the order one exchange gives. Where the
    FFT is a kernel that takes each row on its own, each slab's FFT runs
    beside the previous slab's exchange; elsewhere the FFT of all rows
    runs first, so the result is the same bits for every K."""
    rows = int(xr.shape[-2])
    slab = rows // chunks
    per_slab = _rows_alone(int(xr.shape[-1]), rows_of(xr.shape), xr.device)
    if not per_slab:
        xr, xi = local_fft(xr, xi, direction)
    pending = []
    for c in range(chunks):
        part = slice(c * slab, (c + 1) * slab)
        yr, yi = xr[..., part, :], xi[..., part, :]
        if per_slab:
            yr, yi = local_fft(yr, yi, direction)
        if twiddle is not None:
            tc, ts = twiddle(c * slab, slab)
            yr, yi = yr * tc - yi * ts, yr * ts + yi * tc
        pending.append((comm.all_to_all(yr, group, -1, -2, async_op=True),
                        comm.all_to_all(yi, group, -1, -2, async_op=True)))
    parts = [(a.wait(), b.wait()) for a, b in pending]  # each [..., slab*p, L/p]

    def restack(arrs):
        # slab c holds the rows d*rows + c*slab + r in (d, r) order:
        # (c, d, r) -> (d, c, r)
        if chunks == 1:
            return arrs[0]
        a = torch.stack(arrs, dim=-3)
        lead, cols = a.shape[:-3], a.shape[-1]
        a = a.reshape(*lead, chunks, p, slab, cols).transpose(-4, -3)
        return a.reshape(*lead, rows * p, cols)

    return restack([a for a, _ in parts]), restack([b for _, b in parts])


def four_step_local(br: torch.Tensor, bi: torch.Tensor, *, n1: int, n2: int,
                    direction: Direction, p: int, idx: int, group, chunks: int = 1):
    """One four-step pass on this rank's block of B[j2, j1]
    ([..., n2, n1/p], columns j1 from idx*n1/p) -> its block of
    Y[k1, k2] ([..., n1, n2/p], columns k2 from idx*n2/p); forward
    unscaled, inverse 1/(n1*n2). `chunks` pipelines the column stage
    (`exchange_slabs`)."""
    n = n1 * n2
    row0 = idx * (n1 // p)
    xr, xi = _swap(br, bi)  # [..., n1/p, n2]: the column FFTs run along rows
    tc, ts = twiddle_cs(n1 // p, n2, n, row0, direction, xr.device)

    def twiddle(first: int, k: int):
        return tc[first:first + k], ts[first:first + k]

    yr, yi = exchange_slabs(xr, xi, direction, p, group, chunks, twiddle)  # [..., n1, n2/p]
    dr, di = local_fft(*_swap(yr, yi), direction)  # D[k2 local, k1]
    return _swap(dr, di)


def four_step_fft_sharded_split(xr, xi, mesh, axis_name: str = "tp",
                                direction=FORWARD, n1: int | None = None,
                                flatten: bool = True, chunks: int = 1,
                                batch_axes: tuple | None = None):
    """Sharded single transform on split planes: the same whole [..., n]
    re/im pair on every rank -> the spectrum pair.

    `flatten=True` returns the whole [..., n] spectrum on every rank;
    `flatten=False` this rank's block [..., n1, n2/p] of the matrix pair
    Y[k1, k2], sharded over k2, for fused downstream pointwise stages.

    `chunks=K` pipelines the column stage: K slabs of column FFT,
    twiddle and all_to_all, each transfer beside the next slab's compute.
    The result is identical; K must divide n1/p.

    `batch_axes` optionally names a mesh axis per leading batch dim
    (None: not split): the rank takes its block of those dims too and the
    transform distributes over `axis_name` (dist.fft2_mesh2d is built on
    this); with `flatten=False` the block is returned.
    """
    xr, xi = on_mesh(xr, mesh), on_mesh(xi, mesh)
    check_planes(xr, xi, "four_step_fft_sharded_split")
    direction = Direction(int(direction))
    n = int(xr.shape[-1])
    n1_, n2_ = split_n(n, n1)
    p, idx, group = axis(mesh, axis_name)
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1_} and n2={n2_}"
        )
    chunks = int(chunks)
    if chunks < 1 or (n1_ // p) % chunks:
        raise ValueError(
            f"chunks={chunks} must be >= 1 and divide n1/p = {n1_ // p}"
        )
    split_dims = []
    if batch_axes is not None:
        if len(batch_axes) != xr.ndim - 1:
            raise ValueError(
                f"batch_axes {batch_axes} must name one entry per batch "
                f"dim ({xr.ndim - 1})"
            )
        if axis_name in batch_axes:
            raise ValueError(
                f"batch_axes may not reuse the transform axis {axis_name!r}"
            )
        for d, (ax, size) in enumerate(zip(batch_axes, xr.shape[:-1])):
            if ax is not None and size % mesh[ax].size():
                raise ValueError(
                    f"mesh axis {ax}={mesh[ax].size()} must divide batch "
                    f"dim {size}"
                )
            if ax is not None:
                split_dims.append((d, ax))
    for d, ax in split_dims:
        xr, xi = block(xr, mesh, ax, d), block(xi, mesh, ax, d)
    rows = n1_ // p
    cols = slice(idx * rows, (idx + 1) * rows)
    lead = xr.shape[:-1]
    br = xr.reshape(*lead, n2_, n1_)[..., cols]
    bi = xi.reshape(*lead, n2_, n1_)[..., cols]
    yr, yi = four_step_local(br, bi, n1=n1_, n2=n2_, direction=direction, p=p,
                             idx=idx, group=group, chunks=chunks)
    if not flatten:
        return yr, yi
    # the flat [..., n] interleaves the blocks (X[k2 + n2*k1]): gather
    yr, yi = gather(yr, mesh, axis_name, -1), gather(yi, mesh, axis_name, -1)
    for d, ax in split_dims:
        yr, yi = gather(yr, mesh, ax, d), gather(yi, mesh, ax, d)
    return yr.reshape(*yr.shape[:-2], n), yi.reshape(*yi.shape[:-2], n)
