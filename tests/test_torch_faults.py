"""Repairs of faults found by holding the port's signatures against the
JAX package's (ROADMAP Queue 3 faults 1 and 2; fault 3, `fft_split`'s
`precision=`, is tested in tests/test_torch_lowprec.py).

1. The JAX kernel entries take `interpret` 4th, the port took `scale`:
   `(xr, xi, FORWARD, False)` returned all zeros in the port. `scale` is
   keyword-only now, so the JAX positional call raises TypeError.
2. The JAX `FilterPlan` takes `time_axis` 4th, the port took `num_taps`:
   `FilterPlan(params, None, None, 65)` designed 65 taps where JAX
   designs 129. The port takes `time_axis` in JAX's position.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cplx, oracle, planes, snr_db, tt
from fftlab.dsp.filtering import FilterParams as JxParams
from fftlab.dsp.filtering import FilterType as JxType
from fftlab.plan.filter_plan import FilterPlan as JxFilterPlan
from fftlab_torch import FORWARD
from fftlab_torch.dsp.filtering import FilterParams, FilterType
from fftlab_torch.kernels import fourstep_vmem, resident_vmem, threestep_vmem
from fftlab_torch.plan.filter_plan import FilterPlan

ENTRIES = {
    "fft_split_large": (fourstep_vmem.fft_split_large, 1 << 15),
    "fft_split_resident": (resident_vmem.fft_split_resident, 1 << 15),
    "fft_split_huge": (threestep_vmem.fft_split_huge, 1 << 21),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_positional_fourth_argument_raises(name):
    fn, n = ENTRIES[name]
    x = torch.zeros(1, n)
    with pytest.raises(TypeError):
        fn(x, x, FORWARD, False)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_scale_by_keyword(name):
    fn, n = ENTRIES[name]
    xr, xi = planes(3, (1, n))
    got = cplx(*fn(tt(xr), tt(xi), FORWARD, scale=0.5))
    assert snr_db(got, oracle(xr, xi, -1, 0.5)) >= 120.0


def test_filter_plan_fourth_argument_is_time_axis():
    plan = FilterPlan(FilterParams(FilterType.LOWPASS, 1000, 0, 8000), None, None, 65,
                      device="cpu")
    jplan = JxFilterPlan(JxParams(JxType.LOWPASS, 1000, 0, 8000), None, None, 65)
    assert plan.nh == jplan.nh == 129
    assert plan.time_axis == jplan.time_axis == 65
    np.testing.assert_allclose(plan.h, np.asarray(jplan.h), atol=1e-7)


def test_filter_plan_time_axis_keyword():
    plan = FilterPlan(np.ones(9) / 9.0, time_axis="t", num_taps=65, device="cpu")
    assert plan.time_axis == "t" and plan.nh == 9
    assert FilterPlan(np.ones(9), device="cpu").time_axis == "sp"
