"""fftlab_torch.bench.timing's slope protocol on the CPU, under the
contracts of the JAX package's (tests/test_aux.py:386-620): the
slope-validity guard, `min_slope` ignoring one-sided spikes and, with
three chain lengths, refusing a deflated pair, `chain_time`'s raw
sample, `slope_time` growing with the work, and the copy-chain
bandwidth's byte count. The card's readings are chip_smoke.py's
(phase 4i)."""

import numpy as np
import pytest
import torch

from fftlab_torch.bench import timing


def test_protocol_name():
    import fftlab.bench.timing as jx

    assert timing.PROTOCOL == jx.PROTOCOL == "slope"


def test_slope_valid_guard():
    assert not timing.slope_valid(-1.35)
    assert not timing.slope_valid(0.0)
    assert not timing.slope_valid(float("nan"))
    assert not timing.slope_valid(float("inf"))
    assert timing.slope_valid(2.5)
    assert not timing.slope_valid(0.5, floor_ms=1.0)
    assert timing.slope_valid(1.5, floor_ms=1.0)


def test_min_slope_ignores_one_sided_spikes():
    true_cost, fixed = 2e-3, 30e-3
    raw = {8: [fixed + 8 * true_cost, fixed + 8 * true_cost + 0.25,
               fixed + 8 * true_cost + 0.01],
           48: [fixed + 48 * true_cost + 0.5, fixed + 48 * true_cost,
                fixed + 48 * true_cost + 0.03]}
    assert abs(timing.min_slope(raw) - true_cost) < 1e-9


def test_min_slope_three_ks_rejects_deflation():
    c, d = 2e-3, 30e-3
    raw = {8: [d + 8 * c + 0.04, d + 8 * c + 0.05],
           24: [d + 24 * c, d + 24 * c + 0.01],
           48: [d + 48 * c, d + 48 * c + 0.2]}
    assert abs(timing.min_slope(raw) - c) < 1e-9
    assert (min(raw[48]) - min(raw[8])) / 40 < c


@pytest.mark.parametrize("raw", [
    {2: [1.0, 1.2], 8: [4.0, 3.5]},
    {6: [0.3, 0.2], 24: [0.9], 64: [2.0, 2.5]},
    {1: [5.0], 3: [4.0], 9: [7.0]},
])
def test_min_slope_equals_jax(raw):
    import fftlab.bench.timing as jx

    assert timing.min_slope(raw) == jx.min_slope(raw)


def test_chain_time_return_raw_shape():
    x = torch.ones(8, 128)
    raw = timing.chain_time(lambda a: (a * 1.0001,), lambda i: (x + float(i),),
                            ks=(2, 8), repeats=3, return_raw=True)
    assert sorted(raw) == [2, 8]
    assert all(len(v) == 3 for v in raw.values())
    assert all(t > 0 for v in raw.values() for t in v)
    slopes = timing.chain_time(lambda a: (a * 1.0001,), lambda i: (x + float(i),),
                               ks=(2, 8), repeats=3, return_all=True)
    assert len(slopes) == 3


def test_chain_time_chains_and_makes_fresh_states():
    """Each application consumes the last one's output, and every repeat
    starts from a state of its own."""
    seen, steps = [], []

    def mk(r):
        seen.append(r)
        return (torch.full((4,), float(r)),)

    def step(a):
        steps.append(float(a[0]))
        return (a + 1.0,)

    timing.chain_time(step, mk, ks=(2, 3), repeats=2, return_raw=True)
    assert len(set(seen)) == len(seen) == 1 + 2 * 2
    # the warm-up, then per repeat a 2-chain and a 3-chain, each counting up
    r1 = seen[1]
    assert steps[1:6] == [r1, r1 + 1, seen[2], seen[2] + 1, seen[2] + 2]


def test_slope_time_monotone_in_work():
    big = torch.ones(256, 2048)
    small = torch.ones(8, 64)

    def heavy(a):
        for _ in range(30):
            a = torch.sin(a) * 1.0001
        return a

    t_small = timing.slope_time(heavy, lambda i: (small + i,), iters=4)
    t_big = timing.slope_time(heavy, lambda i: (big + i,), iters=4)
    assert t_big > t_small


def test_slope_time_gives_every_call_fresh_arguments():
    used = []
    timing.slope_time(lambda a: used.append(int(a)), lambda i: (torch.tensor(i),),
                      iters=6, repeats=2)
    assert len(used) == len(set(used)) == 1 + 2 * (2 + 6)


def test_copy_bandwidth_counts_16_bytes_an_element(monkeypatch):
    """GB/s = 16 bytes (two float32 planes, each read and written) times the
    elements of one plane, over the min-slope seconds of a step."""
    calls = []

    def fake_chain(step, mk, ks, repeats, return_raw):
        a, b = mk(0)
        calls.append((tuple(a.shape), tuple(ks), repeats))
        return {k: [k * 1e-3] for k in ks}  # 1 ms a step

    monkeypatch.setattr(timing, "chain_time", fake_chain)
    assert timing.copy_bandwidth(1 << 20, device="cpu") == pytest.approx(
        16 * (1 << 17) / 1e-3 / 1e9)
    assert timing.quick_bandwidth(device="cpu") == pytest.approx(16 * 16 * (1 << 18) / 1e-3 / 1e9)
    assert calls == [((16, 1 << 13), (4, 64), 3), ((16, 1 << 18), (6, 24, 64), 2)]


def test_copy_bandwidth_on_the_cpu_is_a_positive_rate():
    gbps = timing.copy_bandwidth(1 << 22, device="cpu")
    assert np.isfinite(gbps) and (gbps > 0 or gbps == -1.0)


def test_copy_bandwidth_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there (chip_smoke phase 4i)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.quick_bandwidth()
