"""The r2c cells' entry into fftlab_torch: a real-to-complex split plan
made with the ESTIMATE flags (nothing is timed or written to wisdom),
executed on each call's real plane."""

from __future__ import annotations


def build(config: dict, traffic: dict, consts: dict, device):
    """(call, route): call(xr, xi) -> (yr, yi), the n/2+1 one-sided bins of
    xr (xi, which the harness draws for every kind, is not read); route
    is Plan.algorithm."""
    from fftlab_torch.plan.api import plan_r2c_1d_split
    from fftlab_torch.plan.flags import Flags

    if traffic["direction"] != "forward":
        raise ValueError(f"an r2c runs forward; got {traffic['direction']!r}")
    plan = plan_r2c_1d_split(int(config["n"]), flags=Flags.ESTIMATE,
                             batch=int(traffic["rows"]), device=device)
    execute = plan.execute

    def call(xr, xi):
        return execute(xr)

    return call, plan.algorithm
