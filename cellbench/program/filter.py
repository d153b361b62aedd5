"""The sandwich cells' entry into fftlab_torch: `spectral_filter_auto`,
the dispatcher that dsp.filtering, dsp.convolution and Bluestein share,
with the response made once at set-up."""

from __future__ import annotations


def build(config: dict, traffic: dict, consts: dict, device):
    """(call, route): call(xr, xi) -> (yr, yi); route is what
    `select_filter_impl` picks for n."""
    from fftlab_torch.plan.dispatch import select_filter_impl, spectral_filter_auto

    if traffic["direction"] != "forward":
        raise ValueError(f"the sandwich runs forward; got {traffic['direction']!r}")
    hr, hi = consts["hr"], consts["hi"]

    def call(xr, xi):
        return spectral_filter_auto(xr, xi, hr, hi)

    return call, select_filter_impl(int(config["n"]))
