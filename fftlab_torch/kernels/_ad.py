"""The adjoint of the kernel transforms (counterpart of
fftlab/kernels/_ad.py).

Every kernel transform has one convention, forward unscaled and inverse
1/n, so all share one adjoint: the DFT is linear, and the adjoint of the
split-plane map [[Fr, -Fi], [Fi, Fr]] is its transpose, the transform in
the opposite direction, rescaled: times n for the adjoint of the forward
(whose opposite, the inverse, applies 1/n) and times 1/n for the adjoint
of the inverse. The rescale is folded into the opposite transform's
`scale`, so the backward is one more call of the same kernels: on a CUDA
tensor they launch, on a CPU tensor their plain versions run. There is no
backward kernel of its own, as in the JAX package.
"""

from __future__ import annotations

import torch

from fftlab_torch.core.types import FORWARD, INVERSE, Direction


def make_differentiable(fft_fn):
    """`fft_fn(xr, xi, direction, scale=...) -> (yr, yi)` as a function
    `(xr, xi, direction=FORWARD) -> (yr, yi)` that torch.autograd
    differentiates through the opposite-direction transform."""

    class Transform(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xr, xi, direction):
            ctx.direction = Direction(int(direction))
            return fft_fn(xr, xi, ctx.direction)

        @staticmethod
        def backward(ctx, gr, gi):
            n = int(gr.shape[-1])
            opp = Direction(-int(ctx.direction))
            # the inverse applies 1/n: times n gives the unscaled adjoint of
            # the forward; the adjoint of the inverse keeps its 1/n
            scale = float(n) if opp == INVERSE else 1.0 / n
            br, bi = fft_fn(gr.contiguous(), gi.contiguous(), opp, scale=scale)
            return br, bi, None

    def transform(xr: torch.Tensor, xi: torch.Tensor, direction=FORWARD):
        return Transform.apply(xr, xi, direction)

    transform.__doc__ = (f"`{fft_fn.__name__}` with its adjoint for torch.autograd: "
                         "the opposite-direction transform, rescaled.")
    return transform
