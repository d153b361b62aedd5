"""2D FFT distributed over BOTH axes of a 2D mesh (counterpart of
fftlab/dist/fft2_mesh2d.py:37-104).

`dist.fft2_sharded` (pencil decomposition) shards rows and runs each 1D
pass locally, while a full row and column fit one rank. Here the image
is BLOCK-sharded over a 2D mesh (rows over one axis, columns over the
other), and each 1D pass is itself a four-step distributed transform
(`four_step_split.four_step_local`):

    step 1  C-axis FFT of every row: rows stay split over `r_axis` as
            the batch; each row's transform distributes over `c_axis`
    step 2  R-axis FFT of every C-bin: bins stay split over `c_axis` as
            the batch; each bin's transform distributes over `r_axis`

No rank holds more than its block. Between the steps, where the JAX
package lets XLA reshard the R axis, one all_to_all over `r_axis` turns
this rank's contiguous rows into its columns j1 of R = r1*r2.
"""

from __future__ import annotations

from fftlab_torch.core.types import FORWARD, Direction
from fftlab_torch.dist import comm
from fftlab_torch.dist.four_step import split_n
from fftlab_torch.dist.four_step_split import four_step_local
from fftlab_torch.dist.mesh import axis, gather, on_mesh
from fftlab_torch.kernels._common import check_planes


def fft2_mesh2d_split(xr, xi, mesh, r_axis: str = "a",
                      c_axis: str = "b", direction=FORWARD,
                      flatten: bool = True, r1: int | None = None,
                      c1: int | None = None):
    """2D FFT of [R, C] split planes with both axes distributed; the same
    whole planes on every rank.

    `r_axis` splits the R dim (and distributes the R-axis transforms);
    `c_axis` splits the C-bins (and distributes the C-axis transforms).
    Inverse is 1/(R*C) scaled. `r1`/`c1` override the four-step
    factorizations R = r1*r2 / C = c1*c2 (default ~sqrt split).

    flatten=True returns the whole [R, C] pair on every rank, as
    np.fft.fft2 orients it (row index = R). flatten=False returns this
    rank's block [c1, c2/pc, r1, r2/pa] of the [c1, c2, r1, r2]
    factor-matrix pair (sharded as the JAX package's
    P(None, c_axis, None, r_axis)): spectrum bin (kR, kC) lives at
    [kC // c2, kC % c2, kR // r2, kR % r2].
    """
    xr, xi = on_mesh(xr, mesh), on_mesh(xi, mesh)
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(
            f"fft2_mesh2d_split expects matching [R, C] planes; got "
            f"{tuple(xr.shape)} / {tuple(xi.shape)}"
        )
    check_planes(xr, xi, "fft2_mesh2d_split")
    direction = Direction(int(direction))
    R, C = int(xr.shape[0]), int(xr.shape[1])
    pa, ia, ga = axis(mesh, r_axis)
    pc, ic, gc = axis(mesh, c_axis)
    r1, r2 = split_n(R, r1)
    c1, c2 = split_n(C, c1)
    if c1 % pc or c2 % pc:
        raise ValueError(
            f"mesh axis {c_axis}={pc} must divide both factors "
            f"({c1}, {c2}) of C={C} (override with c1=...)"
        )
    if r1 % pa or r2 % pa:
        raise ValueError(
            f"mesh axis {r_axis}={pa} must divide both factors "
            f"({r1}, {r2}) of R={R} (override with r1=...)"
        )

    # step 1: this rank's rows R/pa, and its columns j1 of C = c1*c2
    rows, cols = R // pa, c1 // pc
    take = lambda x: x[ia * rows:(ia + 1) * rows].reshape(rows, c2, c1)[
        ..., ic * cols:(ic + 1) * cols]
    yr, yi = four_step_local(take(xr), take(xi), n1=c1, n2=c2, direction=direction,
                             p=pc, idx=ic, group=gc)  # [R/pa, c1, c2/pc]

    # step 2: bins [c1, c2/pc] as the batch, R as the transform. This rank
    # holds the rows j = j1 + r1*j2 with j2 in its block of r2; the
    # four-step wants every j2 and its block of j1
    def regroup(y):
        z = y.permute(1, 2, 0).reshape(c1, c2 // pc, r2 // pa, r1)
        return comm.all_to_all(z, ga, split_dim=-1, concat_dim=-2)  # [c1, c2/pc, r2, r1/pa]

    wr, wi = four_step_local(regroup(yr), regroup(yi), n1=r1, n2=r2, direction=direction,
                             p=pa, idx=ia, group=ga)  # [c1, c2/pc, r1, r2/pa]
    if not flatten:
        return wr, wi

    def whole(w):
        w = gather(gather(w, mesh, r_axis, -1), mesh, c_axis, 1)  # [c1, c2, r1, r2]
        return w.reshape(C, R).transpose(0, 1).contiguous()

    return whole(wr), whole(wi)
