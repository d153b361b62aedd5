"""fftlab_torch FilterPlan (the serving API) against the JAX package's
FilterPlan and np.convolve, on CPU plans: whole signals, two channels,
the packed-real path, streaming continuity, reset, validation, the long-
tap block path, and a stream begun in the JAX package and continued in
the port.

Tolerances are the JAX suite's (tests/test_filter_plan.py): 1e-4 absolute
against the convolution and between routes; 2e-4 between a stream and a
whole-signal call, the bound of the JAX suite's stream test on the
overlap-save kernel route (:75-89), which a CPU plan here takes (the
stream filters unpacked, the whole call packed: frames fall elsewhere
and float32 rounding differs by up to about 2e-6 of the peak output)."""

import numpy as np
import pytest
import torch

import fftlab.plan.filter_plan as jx_fp
from _torch_parity import snr_db
from fftlab.dsp.filtering import FilterParams as JxParams
from fftlab.dsp.filtering import FilterType as JxType
from fftlab_torch import FilterParams, FilterPlan, FilterType
from fftlab_torch.kernels import os_filter_vmem


def conv(x, h, n=None):
    y = np.convolve(np.asarray(x, np.float64), np.asarray(h, np.float64))
    return y[: len(x) if n is None else n]


def rng_case(seed, n, nh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(nh).astype(np.float32))


def test_whole_signal_matches_jax_and_convolution():
    x, h = rng_case(0, 4096, 33)
    plan = FilterPlan(h, device="cpu")
    got = plan(x).numpy()
    np.testing.assert_allclose(got, conv(x, h), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jx_fp.FilterPlan(h)(x)), atol=1e-4)


def test_batched_signals():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    h = rng.standard_normal(21)
    got = FilterPlan(h, device="cpu")(x)
    assert got.shape == (3, 2000) and got.dtype == torch.float32
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), conv(x[c], h), atol=1e-4)


def test_two_channels():
    a, h = rng_case(1, 2048, 17)
    b, _ = rng_case(2, 2048, 17)
    ya, yb = FilterPlan(h, device="cpu")(a, b)
    ja, jb = jx_fp.FilterPlan(h)(a, b)
    np.testing.assert_allclose(ya.numpy(), conv(a, h), atol=1e-4)
    np.testing.assert_allclose(yb.numpy(), conv(b, h), atol=1e-4)
    np.testing.assert_allclose(ya.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(yb.numpy(), np.asarray(jb), atol=1e-4)


@pytest.mark.parametrize("n", [4096, 4097, 5000])
def test_packed_real_matches_unpacked(n):
    x, h = rng_case(7, n, 33)
    plan = FilterPlan(h, device="cpu")
    assert plan._call_packed_real(torch.from_numpy(x)) is not None
    got = plan(x).numpy()
    assert got.shape == (n,)
    want_r, _ = plan(x, np.zeros(n, np.float32))
    np.testing.assert_allclose(got, want_r.numpy(), atol=1e-4)
    np.testing.assert_allclose(got, conv(x, h), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jx_fp.FilterPlan(h)(x)), atol=1e-4)


def test_packed_real_skips_short_signals():
    plan = FilterPlan(np.ones(9) / 9.0, device="cpu")
    assert plan._call_packed_real(torch.ones(64)) is None


@pytest.mark.parametrize("nh", [1, 65])
def test_streaming_continuity(nh):
    x, h = rng_case(2, 6000, nh)
    plan = FilterPlan(h, device="cpu")
    chunks = [x[0:1000], x[1000:1500], x[1500:1501], x[1501:4096], x[4096:6000]]
    got = torch.cat([plan.stream(c) for c in chunks]).numpy()
    plan.reset()
    want = plan(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, conv(x, h), atol=1e-4)


def test_stream_empty_chunk_keeps_state():
    x, h = rng_case(4, 3000, 33)
    plan = FilterPlan(h, device="cpu")
    a = plan.stream(x[:1000])
    assert plan.stream(x[:0]).shape == (0,)
    b = plan.stream(x[1000:])
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), conv(x, h), atol=1e-4)


def test_reset_restarts_stream():
    rng = np.random.default_rng(3)
    plan = FilterPlan(rng.standard_normal(9), device="cpu")
    c = rng.standard_normal(512).astype(np.float32)
    y1 = plan.stream(c)
    plan.reset()
    assert torch.equal(plan.stream(c), y1)


@pytest.mark.parametrize("split", [700, 2048])
def test_stream_continued_from_jax_tail(split):
    """A stream begun in the JAX package continues in the port from the
    JAX plan's numbers (taps, fft_size, carried tail): the two halves are
    the whole."""
    x, h = rng_case(11, 5000, 65)
    jplan = jx_fp.FilterPlan(h)
    first = [np.asarray(jplan.stream(x[:split // 2])),
             np.asarray(jplan.stream(x[split // 2:split]))]
    plan = FilterPlan.from_jax(jplan.h, jplan.fft_size, jplan._tail, device="cpu")
    assert plan.nh == jplan.nh and plan.fft_size == jplan.fft_size
    second = [plan.stream(x[split:3000]).numpy(), plan.stream(x[3000:]).numpy()]
    got = np.concatenate(first + second)
    np.testing.assert_allclose(got, conv(x, h), atol=2e-4)
    np.testing.assert_allclose(got, FilterPlan(h, device="cpu")(x).numpy(), atol=2e-4)


def test_from_jax_before_first_chunk():
    x, h = rng_case(12, 3000, 17)
    plan = FilterPlan.from_jax(h, 256, None, device="cpu")
    np.testing.assert_allclose(plan.stream(x).numpy(), conv(x, h), atol=1e-4)
    with pytest.raises(ValueError, match="tail"):
        FilterPlan.from_jax(h, 256, np.zeros(5, np.float32), device="cpu")


def test_from_filter_params():
    p = FilterParams(FilterType.LOWPASS, 0.1, sample_rate=1.0, transition_width=0.02)
    plan = FilterPlan(p, num_taps=65, device="cpu")
    jplan = jx_fp.FilterPlan(JxParams(JxType.LOWPASS, 0.1, sample_rate=1.0,
                                      transition_width=0.02), num_taps=65)
    assert plan.nh == 65
    np.testing.assert_allclose(plan.h, jplan.h, atol=1e-7)
    x = np.random.default_rng(4).standard_normal(1024).astype(np.float32)
    y = plan(x).numpy()
    assert y.shape == (1024,) and np.all(np.isfinite(y))
    np.testing.assert_allclose(y, np.asarray(jplan(x)), atol=1e-4)


def test_validation():
    with pytest.raises(ValueError):
        FilterPlan(np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError):
        FilterPlan(np.zeros(100), fft_size=128, device="cpu")
    plan = FilterPlan(np.ones(5), device="cpu")
    with pytest.raises(ValueError):
        plan.stream(np.zeros((2, 10)))


def test_mesh_not_ported():
    """FilterPlan(mesh=) used to raise NotImplementedError; it now runs the
    sharded overlap-save (tests/test_torch_dist_split.py holds it against
    the JAX mesh plan over 8 ranks). On a world of one rank it equals the
    single-device plan and float64 np.convolve (>= 110 and 100 dB)."""
    import torch.distributed as dist

    from fftlab_torch.dist import make_mesh_1d

    mesh = make_mesh_1d("sp", device_type="cpu")
    try:
        h = np.random.default_rng(5).standard_normal(33).astype(np.float32)
        x = np.random.default_rng(6).standard_normal(4096).astype(np.float32)
        plan = FilterPlan(h, mesh=mesh, time_axis="sp")
        assert "mesh[sp]=1" in plan.describe()
        xt = torch.from_numpy(x)
        want = FilterPlan(h, device="cpu").causal(xt, torch.zeros_like(xt))[0]
        got = plan(x).numpy()
        assert snr_db(got, want.numpy()) >= 110.0
        assert snr_db(got, np.convolve(x.astype(np.float64), h)[:4096]) >= 100.0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("nh,fft_size", [(9, None), (33, None), (129, None),
                                         (65, 1000), (1025, None), (129, 40000)])
def test_kernel_frame_is_the_jax_rule(nh, fft_size):
    h = np.ones(nh, np.float32)
    plan = FilterPlan(h, fft_size=fft_size, device="cpu")
    jplan = jx_fp.FilterPlan(h, fft_size=fft_size)
    assert plan.fft_size == jplan.fft_size
    assert plan.kernel_fft_size() == jplan._pallas_fft_size()
    assert plan.uses_kernel() == os_filter_vmem.taps_fit(nh, plan.kernel_fft_size())


def test_long_taps_take_the_block_path():
    """Taps whose halo fills the kernel's 16K frame take the tensor-op
    block path (the JAX package's size rule), and still filter."""
    h = np.ones(16384, np.float32) / 16384.0
    plan = FilterPlan(h, device="cpu")
    assert not plan.uses_kernel() and "blocks" in plan.describe()
    x = np.random.default_rng(5).standard_normal(1 << 15).astype(np.float32)
    np.testing.assert_allclose(plan(x).numpy(), conv(x, h), atol=1e-3)


def test_taps_longer_than_the_kernel_frame():
    x, h = rng_case(8, 30000, 20000)
    h = h / 20000
    plan = FilterPlan(h, device="cpu")
    assert not plan.uses_kernel()
    np.testing.assert_allclose(plan(x).numpy(), conv(x, h), atol=1e-3)


def test_block_path_streams_too():
    x, h = rng_case(6, 40000, 2000)

    class BlockPlan(FilterPlan):
        def uses_kernel(self):
            return False

    plan = BlockPlan(h, fft_size=4096, device="cpu")
    got = torch.cat([plan.stream(x[:15000]), plan.stream(x[15000:])]).numpy()
    np.testing.assert_allclose(got, conv(x, h), atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jx_fp.FilterPlan(h, fft_size=4096)(x)),
                               atol=1e-3)


def test_describe_and_device():
    plan = FilterPlan(np.ones(129), device="cpu")
    assert plan.describe() == ("FilterPlan(nh=129, fft_size=1024, hop=896, "
                               "os_filter[1024], cpu)")
    assert plan(np.zeros(10)).device.type == "cpu"


@pytest.mark.parametrize("make", [lambda h: FilterPlan(h),
                                  lambda h: FilterPlan.from_jax(h, 1024)],
                         ids=["init", "from_jax"])
def test_default_device_is_the_card(monkeypatch, make):
    """A plan runs on the card unless built with device="cpu": without
    CUDA the default raises, naming device="cpu", and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make(np.ones(9) / 9.0)
