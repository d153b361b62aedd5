"""The c2c cells' entry into fftlab_torch: a split-plane plan made with
the ESTIMATE flags (nothing is timed or written to wisdom), executed on
each call's (re, im) planes."""

from __future__ import annotations


def build(config: dict, traffic: dict, consts: dict, device):
    """(call, route): call(xr, xi) -> (yr, yi); route is Plan.algorithm."""
    from fftlab_torch.core.types import FORWARD, INVERSE
    from fftlab_torch.plan.api import plan_dft_1d_split
    from fftlab_torch.plan.flags import Flags

    direction = {"forward": FORWARD, "inverse": INVERSE}[traffic["direction"]]
    plan = plan_dft_1d_split(int(config["n"]), direction, flags=Flags.ESTIMATE,
                             batch=int(traffic["rows"]), device=device)
    execute = plan.execute

    def call(xr, xi):
        return execute((xr, xi))

    return call, plan.algorithm
