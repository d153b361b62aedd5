"""Gather-free TP spectral pipeline (counterpart of
fftlab/dist/tp_pipeline.py:47-154): four-step FFT -> H -> inverse with
every stage sharded and no gather between them.

A spectral filter never needs the flat spectrum, whose order interleaves
the blocks: the pointwise multiply is order-agnostic. So the sandwich
runs in the sharded matrix domain:

    x.reshape(n2, n1)   [split over j1]
      --four-step-->    Y[k1, k2]          [split over k2]   (all_to_all)
      --H2 multiply-->  Y * H.reshape(n1, n2)  [same split, no exchange]
      --four-step-->    y.reshape(n2, n1)  [split over j1]   (all_to_all)

The inverse is the same pass with the factor roles swapped: Y[k1, k2]
read as the input B'[j2', j1'] of an (n1', n2') = (n2, n1) four-step
lands on x.reshape(n2, n1), so input and output are split alike and
filters chain without a re-split. Two all_to_alls of each plane, nothing
else. The local FFTs run on the kernels (`four_step_split.local_fft`).
"""

from __future__ import annotations

from fftlab_torch.core.types import FORWARD, Direction
from fftlab_torch.dist.four_step import split_n
from fftlab_torch.dist.four_step_split import four_step_local
from fftlab_torch.dist.mesh import axis, gather, on_mesh
from fftlab_torch.kernels._common import check_planes


def tp_spectral_filter_split(xr, xi, hr, hi, mesh,
                             axis_name: str = "tp",
                             n1: int | None = None,
                             flatten: bool = False):
    """FFT -> H -> IFFT on one huge signal, TP-sharded end to end.

    xr, xi: the same whole [..., n] planes on every rank. hr, hi: the
    length-n frequency response H[k] in natural bin order (laid out as
    H2[k1, k2] = H[k2 + n2*k1] = H.reshape(n1, n2)). Returns this rank's
    block [..., n2, n1/p] of the filtered signal as the matrix x.reshape
    (n2, n1), split over j1 as the input is (`flatten=False`, the
    gather-free form), or the whole [..., n] on every rank with
    `flatten=True` (one gather, at the end only).

    Numerics: ifft(fft(x) * H), 1/n scaled (spectral_filter_split).
    """
    xr, xi = on_mesh(xr, mesh), on_mesh(xi, mesh)
    check_planes(xr, xi, "tp_spectral_filter_split")
    n = int(xr.shape[-1])
    n1_, n2_ = split_n(n, n1)
    p, idx, group = axis(mesh, axis_name)
    if n1_ % p or n2_ % p:
        raise ValueError(
            f"mesh axis {axis_name}={p} must divide both n1={n1_} and n2={n2_}"
        )
    batch = xr.shape[:-1]
    j1 = slice(idx * (n1_ // p), (idx + 1) * (n1_ // p))
    k2 = slice(idx * (n2_ // p), (idx + 1) * (n2_ // p))
    h2 = lambda h: on_mesh(h, mesh).float().reshape(n1_, n2_)[:, k2]
    h2r, h2i = h2(hr), h2(hi)
    common = dict(p=p, idx=idx, group=group)
    yr, yi = four_step_local(xr.reshape(*batch, n2_, n1_)[..., j1],
                             xi.reshape(*batch, n2_, n1_)[..., j1], n1=n1_, n2=n2_,
                             direction=FORWARD, **common)  # Y[k1, k2 local]
    gr, gi = yr * h2r - yi * h2i, yr * h2i + yi * h2r
    zr, zi = four_step_local(gr, gi, n1=n2_, n2=n1_, direction=Direction.INVERSE,
                             **common)  # [..., n2, n1/p]
    if flatten:
        return (gather(zr, mesh, axis_name, -1).reshape(*batch, n),
                gather(zi, mesh, axis_name, -1).reshape(*batch, n))
    return zr, zi
