"""Sharded 2D FFT: rows distributed, one all_to_all between the two 1D
passes (counterpart of fftlab/dist/fft2_sharded.py:37-131; the pencil
decomposition of distributed FFT libraries).

Split re/im planes throughout. Layout:

    x [R, C], this rank's rows R/p
      FFT along C (local, every row complete)
      all_to_all: rows -> columns
      FFT along R (local, every column complete)
      (optionally all_to_all back, so the output is row-sharded again)

The local FFTs run through `four_step_split.local_fft` (`fft_rows` at
1024..16384 points).
"""

from __future__ import annotations

from fftlab_torch.core.types import FORWARD, Direction
from fftlab_torch.dist import comm
from fftlab_torch.dist.four_step_split import _swap, exchange_slabs, local_fft
from fftlab_torch.dist.mesh import axis, block, on_mesh
from fftlab_torch.kernels._common import check_planes


def fft2_sharded_split(xr, xi, mesh, axis_name: str = "tp",
                       direction=FORWARD, transposed_out: bool = False,
                       chunks: int = 1):
    """2D FFT of [R, C] split planes with rows sharded over
    `mesh[axis_name]`: the same whole planes on every rank -> this
    rank's block of the spectrum, rows [R/p, C].

    `transposed_out=True` skips the restoring all_to_all and returns
    this rank's block of the spectrum TRANSPOSED ([C/p, R] of [C, R]):
    half the communication when the consumer is orientation-agnostic
    (pointwise filters, magnitude spectra). `chunks=K` pipelines the row
    stage (K all_to_alls beside the compute, see
    dist.four_step_split); K must divide R/p. Inverse is 1/(R*C)
    scaled. Requires the axis size to divide both R and C.
    """
    xr, xi = on_mesh(xr, mesh), on_mesh(xi, mesh)
    check_planes(xr, xi, "fft2_sharded_split")
    direction = Direction(int(direction))
    R, C = int(xr.shape[-2]), int(xr.shape[-1])
    p, _, group = axis(mesh, axis_name)
    if R % p or C % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide rows={R} and cols={C}"
        )
    chunks = int(chunks)
    if chunks < 1 or (R // p) % chunks:
        raise ValueError(f"chunks={chunks} must divide R/p = {R // p}")
    br, bi = block(xr, mesh, axis_name, -2), block(xi, mesh, axis_name, -2)
    cr, ci = exchange_slabs(br, bi, direction, p, group, chunks)  # [R, C/p]
    dr, di = local_fft(*_swap(cr, ci), direction)  # [C/p, R]
    if transposed_out:
        return dr, di
    dr, di = _swap(dr, di)  # [R, C/p] -> rows back: [R/p, C]
    return (comm.all_to_all(dr, group, split_dim=-2, concat_dim=-1),
            comm.all_to_all(di, group, split_dim=-2, concat_dim=-1))
