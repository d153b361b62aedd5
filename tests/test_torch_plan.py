"""fftlab_torch's planner, wisdom, split-route tuning and complex plan API
against fftlab's: ESTIMATE's choices, the candidate sets, MEASURE and
WISDOM_ONLY (the cases of tests/test_plan_validation.py:45-93 and
:204-320, mirrored), the complex plans and one-shot calls, plan caching,
`plan_from_jax` of every complex kind, and the public names.

On the CPU every measurement runs with `device="cpu"`: the port measures
on the card by default and raises without one. Each test gets its own
wisdom file (FFTLAB_WISDOM_PATH) and an empty wisdom table. Gates: port
vs JAX within 1e-10 of the largest output at complex128 and 1e-5 at
complex64 (tests/test_properties.py's tolerances)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab
import fftlab.plan.api as jx_api
import fftlab.plan.planner as jx_planner
from fftlab.plan.flags import Flags as JxFlags
from fftlab.plan.flags import PlanConfig as JxPlanConfig
import fftlab_torch
from _torch_parity import tt
from fftlab_torch.plan import api, planner, split_tuning, wisdom
from fftlab_torch.plan.flags import Flags, PlanConfig

RIGOR = [Flags.ESTIMATE, Flags.MEASURE, Flags.PATIENT, Flags.EXHAUSTIVE, Flags.WISDOM_ONLY]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("FFTLAB_WISDOM_PATH", str(tmp_path / "wisdom.json"))
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)
    wisdom.forget()
    api._cached_plan.cache_clear()
    yield
    wisdom.forget()
    api._cached_plan.cache_clear()


def cx(seed: int, shape, dtype=np.complex128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _all_flag_sets():
    """Every combination of the five rigor flags, with and without the
    behaviour bits."""
    out = []
    for bits in range(32):
        f = Flags(0)
        for i, flag in enumerate((Flags.MEASURE, Flags.PATIENT, Flags.EXHAUSTIVE,
                                  Flags.WISDOM_ONLY, Flags.REAL_INPUT)):
            if bits >> i & 1:
                f |= flag
        out.append(f)
    return out + [Flags.CONSERVE_MEMORY | Flags.PREFER_DEVICE | Flags.THREADED]


# ------------------------------------------------------------------ planner


def test_estimate_and_reference_heuristic_match_jax():
    for leaf in (1024, 64):
        cfg, jcfg = PlanConfig(leaf=leaf), JxPlanConfig(leaf=leaf)
        assert ([planner.estimate_algorithm(n, cfg) for n in range(1, 5001)]
                == [jx_planner.estimate_algorithm(n, jcfg) for n in range(1, 5001)])
    assert ([planner.reference_heuristic(n) for n in range(1, 5001)]
            == [jx_planner.reference_heuristic(n) for n in range(1, 5001)])
    assert planner.estimate_algorithm(7, PlanConfig(algorithm="radix4")) == "radix4"


@pytest.mark.parametrize("n", [1, 2, 7, 64, 97, 256, 1000, 1024, 4096, 8192, 100003])
def test_candidate_algorithms_match_jax(n):
    for flags in _all_flag_sets():
        assert (planner.candidate_algorithms(n, flags, PlanConfig())
                == jx_planner.candidate_algorithms(n, JxFlags(int(flags)), JxPlanConfig()))


def test_measure_mode_records_wisdom():
    name = planner.measure_algorithm(128, fftlab_torch.FORWARD, torch.complex64,
                                     Flags.MEASURE, PlanConfig(), batch=2, iters=2,
                                     device="cpu")
    rec = wisdom.lookup(128, "f32")
    assert rec is not None and rec["algorithm"] == name
    assert rec["platform"] == "cpu" and rec["protocol"] == "perf_counter"
    assert "device_name" not in rec
    assert set(rec["timings_ms"]) == set(planner.candidate_algorithms(128, Flags.MEASURE,
                                                                      PlanConfig()))
    assert name == min(rec["timings_ms"], key=rec["timings_ms"].get)


def test_wisdom_only_without_wisdom_raises():
    with pytest.raises(RuntimeError, match="WISDOM_ONLY"):
        planner.measure_algorithm(4096, fftlab_torch.FORWARD, torch.complex64,
                                  Flags.WISDOM_ONLY, PlanConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="WISDOM_ONLY"):
        api.plan_dft_1d(4096, flags=Flags.WISDOM_ONLY, device="cpu")


def test_measure_on_the_card_by_default_raises_without_one(monkeypatch):
    """MEASURE times where the plan runs, the card unless the caller says
    otherwise: without one it raises, never measuring the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.plan_dft_1d(256, flags=Flags.MEASURE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.plan_dft_1d_split(256, flags=Flags.MEASURE)
    assert wisdom.snapshot() == {}
    assert api.plan_dft_1d(256).algorithm == "stockham_mxu"  # ESTIMATE measures nothing


def test_failing_candidate_fails_the_measurement(monkeypatch):
    """A candidate that raises fails MEASURE with its name; it is not
    skipped and nothing falls back."""
    from fftlab_torch import algos

    reg = algos.build_registry()

    def broken(x, direction=-1):
        raise RuntimeError("launch failed")

    reg["radix4"] = algos.AlgoSpec("radix4", broken, reg["radix4"].supports)
    monkeypatch.setattr(algos, "build_registry", lambda: reg)
    with pytest.raises(RuntimeError, match="candidate 'radix4' failed"):
        planner.measure_algorithm(256, -1, torch.complex64, Flags.MEASURE, PlanConfig(),
                                  batch=1, iters=1, device="cpu")
    assert wisdom.lookup(256, "f32") is None


def test_failing_route_fails_the_tuning(monkeypatch):
    from fftlab_torch.plan import dispatch

    def broken(route, *a, **k):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(dispatch, "run_route", broken)
    with pytest.raises(RuntimeError, match="route 'einsum' at n=512 failed"):
        split_tuning.tune_split_route(512, batch=1, device="cpu")
    assert wisdom.lookup(512, "f32", kind="route") is None


def test_estimate_prefers_flagship():
    assert planner.estimate_algorithm(4096, PlanConfig()) == "stockham_mxu"
    assert planner.estimate_algorithm(100003, PlanConfig()) == "bluestein"


def test_stale_wisdom_algorithm_falls_back():
    wisdom.record(333, "f32", "renamed_algo", 1.0)
    plan = api.plan_dft_1d(333)
    assert plan.algorithm != "renamed_algo"
    x = cx(0, 333, np.complex64)
    np.testing.assert_allclose(plan.execute(tt(x)).numpy(), np.fft.fft(x), atol=1e-2)


def test_wisdom_serves_plans_of_its_platform_only():
    wisdom.record(600, "f32", "mixed_radix", 1.0, extra={"platform": "gpu"})
    assert api.plan_dft_1d(600, device="cpu").algorithm == "stockham_mxu"
    assert api.plan_dft_1d(600, device="cuda").algorithm == "mixed_radix"
    wisdom.record(600, "f64", "bluestein", 1.0)  # no platform: any
    assert api.plan_dft_1d(600, dtype=torch.complex128, device="cpu").algorithm == "bluestein"


def test_plan_measure_then_wisdom_only():
    p = api.plan_dft_1d(192, flags=Flags.MEASURE, device="cpu")
    rec = wisdom.lookup(192, "f32")
    assert rec["algorithm"] == p.algorithm
    q = api.plan_dft_1d(192, flags=Flags.WISDOM_ONLY, device="cpu")
    assert q.algorithm == p.algorithm and wisdom.lookup(192, "f32") is rec
    x = cx(1, (2, 192))
    assert rel_err(q.execute(tt(x)).numpy(), np.fft.fft(x)) <= 1e-10


# ---------------------------------------------------------- split tuning


def test_tune_leaf_and_recall():
    leaf = split_tuning.tune_split_leaf(4096, leaves=(64, 128), batch=1, iters=2,
                                        device="cpu")
    assert leaf in (64, 128)
    assert split_tuning.best_leaf(4096, "cpu") == leaf
    assert split_tuning.best_leaf(4096, "cuda") == 128  # measured on the CPU, not the card
    wisdom.forget()
    assert split_tuning.best_leaf(4096, "cpu") == 128


def test_prime_unreachable_leaves_fall_back():
    assert split_tuning.tune_split_leaf(10007, leaves=(64, 128), persist=False,
                                        device="cpu") == 128


def test_route_tune_records_and_recalls():
    assert split_tuning.best_route(1024, "cpu") is None
    assert split_tuning.tune_split_route(1024, batch=1, device="cpu") == "einsum"
    rec = wisdom.lookup(1024, "f32", kind="route")
    assert rec["algorithm"] == "einsum" and rec["protocol"] == "perf_counter"
    assert rec["platform"] == "cpu" and list(rec["timings_ms"]) == ["einsum"]
    assert split_tuning.best_route(1024, "cpu") == "einsum"


def test_route_candidates_follow_the_dispatch_predicates():
    cands = split_tuning._route_candidates
    assert cands(8192, "cpu") == ["einsum"]  # off the card: einsum only
    assert cands(1024, "cuda") == ["einsum", "smem_rows"]  # below the static 8K floor
    assert cands(16384, "cuda") == ["einsum", "smem_rows"]
    assert cands(1 << 15, "cuda") == ["einsum", "two_pass"]
    assert cands(1 << 21, "cuda") == ["einsum", "two_pass", "three_pass"]
    assert cands(1 << 22, "cuda") == ["einsum", "three_pass"]
    assert cands(1 << 26, "cuda") == ["einsum", "three_pass"]
    assert cands(1000, "cuda") == cands(1 << 27, "cuda") == ["einsum"]


def test_split_plan_measure_records_wisdom():
    p = fftlab_torch.plan_dft_1d_split(512, flags=Flags.MEASURE, batch=1, device="cpu")
    assert p.algorithm == "einsum"
    assert wisdom.lookup(512, "f32", kind="route") is not None


def test_tune_persists_to_file(tmp_path):
    assert split_tuning.tune_split_route(256, batch=1, device="cpu") == "einsum"
    data = json.loads((tmp_path / "wisdom.json").read_text())
    assert data["route:256:f32"]["algorithm"] == "einsum"
    assert data["route:256:f32"]["platform"] == "cpu"


def test_split_plan_wisdom_only_requires_measurement():
    with pytest.raises(RuntimeError, match="WISDOM_ONLY"):
        fftlab_torch.plan_dft_1d_split(2048, flags=Flags.WISDOM_ONLY, device="cpu")
    wisdom.record(2048, "f32", "einsum", 1.0, kind="route", extra={"platform": "cpu"})
    p = fftlab_torch.plan_dft_1d_split(2048, flags=Flags.WISDOM_ONLY, device="cpu")
    assert p.algorithm == "einsum"


def test_split_plan_force_impl_outranks_measure(monkeypatch):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", "einsum")
    p = fftlab_torch.plan_dft_1d_split(512, flags=Flags.MEASURE)
    assert p.algorithm == "einsum"
    assert wisdom.lookup(512, "f32", kind="route") is None  # nothing measured


def test_route_wisdom_platform_filtered():
    wisdom.record(1024, "f32", "einsum", 1.0, kind="route", extra={"platform": "tpu"})
    assert split_tuning.best_route(1024, "cpu") is None
    wisdom.record(1024, "f32", "einsum", 1.0, kind="route", extra={"platform": "cpu"})
    assert split_tuning.best_route(1024, "cpu") == "einsum"
    assert split_tuning.best_route(1024, "cuda") is None
    wisdom.record(1 << 16, "f32", "two_pass", 1.0, kind="route", extra={"platform": "gpu"})
    assert split_tuning.best_route(1 << 16, "cuda") == "two_pass"


def test_precision_reduced_route_never_default():
    wisdom.record(1 << 19, "f32", "two_pass_3x", 1.0, kind="route",
                  extra={"platform": "gpu"})
    assert split_tuning.best_route(1 << 19, "cuda") == "two_pass"


@pytest.fixture
def card_named(monkeypatch):
    """Make this process see one card named "NVIDIA H100 80GB HBM3"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")


def test_route_wisdom_card_filtered(card_named):
    wisdom.record(1 << 16, "f32", "two_pass", 1.0, kind="route",
                  extra={"platform": "gpu", "device_name": "NVIDIA A100-SXM4-80GB"})
    assert split_tuning.best_route(1 << 16, "cuda") is None  # measured on another card
    wisdom.record(1 << 16, "f32", "two_pass", 1.0, kind="route",
                  extra={"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3"})
    assert split_tuning.best_route(1 << 16, "cuda") == "two_pass"


def test_algorithm_wisdom_card_filtered(card_named):
    cfg = PlanConfig(flags=Flags.WISDOM_ONLY)
    wisdom.record(4096, "f32", "radix4", 1.0,
                  extra={"platform": "gpu", "device_name": "NVIDIA A100-SXM4-80GB"})
    with pytest.raises(RuntimeError, match="WISDOM_ONLY"):
        planner.select_algorithm(4096, 1, torch.complex64, cfg, device="cuda")
    wisdom.record(4096, "f32", "radix4", 1.0,
                  extra={"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3"})
    assert planner.select_algorithm(4096, 1, torch.complex64, cfg, device="cuda") == "radix4"


def test_einsum_route_runs_the_recorded_leaf(monkeypatch):
    """A leaf recorded by `tune_split_leaf` is the leaf the einsum route
    then runs, as in the JAX package."""
    from fftlab_torch.algos import split_stockham
    from fftlab_torch.plan.dispatch import run_route

    seen = []
    real = split_stockham.fft_split
    monkeypatch.setattr(split_stockham, "fft_split",
                        lambda xr, xi, direction, leaf: seen.append(leaf) or
                        real(xr, xi, direction, leaf))
    xr, xi = (torch.from_numpy(p) for p in (np.random.default_rng(3).standard_normal((2, 4096)),
                                             np.random.default_rng(4).standard_normal((2, 4096))))
    want = run_route("einsum", xr, xi, fftlab_torch.FORWARD)
    wisdom.record(4096, "f32", "leaf=64", 1.0, kind="split", extra={"platform": "gpu"})
    run_route("einsum", xr, xi, fftlab_torch.FORWARD)  # a record of the card does not serve the CPU
    wisdom.record(4096, "f32", "leaf=64", 1.0, kind="split", extra={"platform": "cpu"})
    got = run_route("einsum", xr, xi, fftlab_torch.FORWARD)
    assert seen == [split_stockham.DEFAULT_LEAF_SPLIT] * 2 + [64]
    z = np.fft.fft(xr.numpy() + 1j * xi.numpy())
    for yr, yi in (want, got):
        assert rel_err(yr.numpy() + 1j * yi.numpy(), z) <= 1e-10


def test_stale_route_wisdom_ignored():
    wisdom.record(8192, "f32", "smem_rows", 1.0, kind="route")
    assert split_tuning.best_route(8192, "cpu") is None  # not a CPU candidate
    wisdom.record(8192, "f32", "pallas_vmem", 1.0, kind="route")
    assert split_tuning.best_route(8192, "cuda") is None  # a JAX route name


def test_unreadable_wisdom_file_is_ignored(monkeypatch, tmp_path):
    (tmp_path / "wisdom.json").write_text("[not a table]")
    monkeypatch.delenv("FFTLAB_NO_WISDOM_FILE", raising=False)
    monkeypatch.setattr(split_tuning, "_WISDOM_FILE_LOADED", False)
    assert split_tuning.best_route(4096, "cpu") is None


def test_wisdom_file_serves_a_later_process(monkeypatch, tmp_path):
    wisdom.record(4096, "f32", "einsum", 0.5, kind="route", extra={"platform": "cpu"})
    wisdom.record(77, "f32", "bluestein", 0.1)
    path = wisdom.export_wisdom()
    assert path == str(tmp_path / "wisdom.json")
    snap = wisdom.snapshot()
    wisdom.forget()
    monkeypatch.delenv("FFTLAB_NO_WISDOM_FILE", raising=False)
    monkeypatch.setattr(split_tuning, "_WISDOM_FILE_LOADED", False)
    assert split_tuning.best_route(4096, "cpu") == "einsum"  # loaded once, lazily
    assert wisdom.snapshot() == snap
    wisdom.record(77, "f32", "mixed_radix", 0.2)
    assert wisdom.import_wisdom(overwrite=False) == 2
    assert wisdom.lookup(77, "f32")["algorithm"] == "mixed_radix"  # this process's wins
    assert wisdom.import_wisdom() == 2
    assert wisdom.lookup(77, "f32")["algorithm"] == "bluestein"


def test_wisdom_default_path_is_the_ports(monkeypatch):
    monkeypatch.delenv("FFTLAB_WISDOM_PATH")
    assert wisdom._default_path().endswith("/.cache/fftlab_torch/wisdom.json")


def test_split_real_plans_take_the_half_size_route():
    wisdom.record(1 << 22, "f32", "einsum", 1.0, kind="route", extra={"platform": "cpu"})
    p = fftlab_torch.plan_r2c_1d_split(1 << 23, flags=Flags.WISDOM_ONLY, device="cpu")
    assert p.algorithm == "rfft_split[einsum]"
    with pytest.raises(RuntimeError, match="half-size"):
        fftlab_torch.plan_c2r_1d_split(1 << 25, flags=Flags.WISDOM_ONLY, device="cpu")


# ------------------------------------------------------------ plan API


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10), (np.complex64, 1e-5)])
@pytest.mark.parametrize("n", [1, 2, 3, 64, 97, 360, 1000, 4096])
def test_fft_ifft_fft_auto_execute_match_jax(n, dtype, tol):
    x = cx(n, (2, n), dtype)
    jx = jnp.asarray(x)
    assert rel_err(fftlab_torch.fft(tt(x)).numpy(), np.asarray(fftlab.fft(jx))) <= tol
    assert rel_err(fftlab_torch.ifft(tt(x)).numpy(), np.asarray(fftlab.ifft(jx))) <= tol
    assert rel_err(fftlab_torch.fft_auto(tt(x), 1).numpy(),
                   np.asarray(fftlab.fft_auto(jx, 1))) <= tol
    plan = fftlab_torch.plan_dft_1d(n, dtype=dtype)
    jplan = fftlab.plan_dft_1d(n, dtype=dtype)
    assert plan.algorithm == jplan.algorithm
    assert rel_err(fftlab_torch.execute(plan, tt(x)).numpy(),
                   np.asarray(fftlab.execute(jplan, jx))) <= tol


@pytest.mark.parametrize("algorithm", ["radix2_dit", "split_radix", "bluestein", "four_step"])
def test_fft_forced_algorithm(algorithm):
    x = cx(5, (2, 256))
    got = fftlab_torch.fft(tt(x), algorithm=algorithm).numpy()
    assert rel_err(got, np.asarray(fftlab.fft(jnp.asarray(x), algorithm=algorithm))) <= 1e-10
    assert rel_err(fftlab_torch.ifft(tt(x), algorithm).numpy(), np.fft.ifft(x)) <= 1e-10


def test_unknown_algorithm_raises():
    with pytest.raises(KeyError):
        fftlab_torch.fft(torch.zeros(64, dtype=torch.complex64), algorithm="warp_drive")


def test_pow2_only_algorithm_on_composite_raises():
    with pytest.raises(ValueError):
        fftlab_torch.fft(torch.zeros(100, dtype=torch.complex64), algorithm="radix2_dit")


def test_plan_reuse_is_cached():
    assert fftlab_torch.plan_dft_1d(2048) is fftlab_torch.plan_dft_1d(2048)
    assert fftlab_torch.plan_dft_1d(2048) is not fftlab_torch.plan_dft_1d(2048, device="cpu")


@pytest.mark.parametrize("make", [
    lambda m: m.plan_dft_1d(512),
    lambda m: m.plan_dft_1d(97, m.INVERSE, dtype=np.complex128),
    lambda m: m.plan_r2c_1d(256),
    lambda m: m.plan_c2r_1d(255),
    lambda m: m.plan_dft_2d(16, 12),
], ids=["c2c", "c2c_inverse_f64", "r2c", "c2r_odd", "2d"])
def test_plan_describe_matches_jax(make):
    p, jp = make(fftlab_torch), make(fftlab)
    assert p.describe() == jp.describe()
    assert (p.kind, p.n, p.direction, p.algorithm) == (jp.kind, jp.n, jp.direction, jp.algorithm)
    p.destroy()  # a no-op


def test_plan_shapes():
    out = fftlab_torch.plan_r2c_1d(256).execute(torch.ones(256))
    assert out.shape == (129,)
    out = fftlab_torch.plan_dft_2d(16, 32).execute(torch.ones(16, 32, dtype=torch.complex64))
    assert out.shape == (16, 32) and abs(complex(out[0, 0]) - 512) < 1e-3


@pytest.mark.parametrize("n", [1, 3, 16, 100, 1024])
def test_real_and_2d_plans_match_jax(n):
    x = np.random.default_rng(n).standard_normal((2, n))
    X = fftlab_torch.plan_r2c_1d(n, dtype=np.float64).execute(tt(x)).numpy()
    jX = np.asarray(fftlab.plan_r2c_1d(n, dtype=np.float64).execute(jnp.asarray(x)))
    assert rel_err(X, jX) <= 1e-10
    y = fftlab_torch.plan_c2r_1d(n, dtype=np.complex128).execute(tt(X)).numpy()
    jy = np.asarray(fftlab.plan_c2r_1d(n, dtype=np.complex128).execute(jnp.asarray(jX)))
    assert rel_err(y, jy) <= 1e-10
    z = cx(n, (3, 2, n))
    for d in (-1, 1):
        got = fftlab_torch.plan_dft_2d(2, n, d, dtype=np.complex128).execute(tt(z)).numpy()
        want = np.asarray(fftlab.plan_dft_2d(2, n, d, dtype=np.complex128).execute(jnp.asarray(z)))
        assert rel_err(got, want) <= 1e-10


JAX_PLANS = [
    lambda: jx_api.plan_dft_1d(64),
    lambda: jx_api.plan_dft_1d(97, fftlab.INVERSE),
    lambda: jx_api.plan_dft_1d(256, config=JxPlanConfig(algorithm="radix4")),
    lambda: jx_api.plan_dft_1d(360, config=JxPlanConfig(algorithm="mixed_radix")),
    lambda: jx_api.plan_r2c_1d(128),
    lambda: jx_api.plan_r2c_1d(15),
    lambda: jx_api.plan_c2r_1d(64),
    lambda: jx_api.plan_dft_2d(12, 8),
    lambda: jx_api.plan_dft_2d(8, 6, config=JxPlanConfig(algorithm="mixed_radix")),
    lambda: jx_api.plan_dft_2d(16, 1031, fftlab.INVERSE),
]


@pytest.mark.parametrize("make", JAX_PLANS, ids=range(len(JAX_PLANS)))
def test_plan_from_jax_complex_kinds(make):
    jplan = make()
    plan = api.plan_from_jax(jplan.algorithm, jplan.n, int(jplan.direction), jplan.kind)
    assert (plan.kind, plan.n, plan.direction, plan.algorithm) == (
        jplan.kind, jplan.n, jplan.direction, jplan.algorithm)
    if jplan.kind == "r2c":
        x = np.random.default_rng(1).standard_normal((2, jplan.n)).astype(np.float32)
    elif jplan.kind == "c2r":
        x = np.fft.rfft(np.random.default_rng(2).standard_normal((2, jplan.n))).astype(np.complex64)
    else:
        shape = (2, *jplan.n) if jplan.kind == "c2c_2d" else (2, jplan.n)
        x = cx(3, shape, np.complex64)
    assert rel_err(plan.execute(tt(x)).numpy(), np.asarray(jplan.execute(jnp.asarray(x)))) <= 1e-5


@pytest.mark.parametrize("algorithm,kind", [("warp_drive", "c2c"), ("rfft[nope]", "r2c"),
                                            ("radix4", "r2c"), ("radix4xnope", "c2c_2d"),
                                            ("stockham_mxu", "c2c_sharded")])
def test_plan_from_jax_unknown_raises(algorithm, kind):
    with pytest.raises(ValueError):
        api.plan_from_jax(algorithm, (8, 8) if kind == "c2c_2d" else 64, -1, kind)


def test_public_names_cover_the_jax_package():
    assert set(fftlab.__all__) <= set(fftlab_torch.__all__)
    for name in fftlab_torch.__all__:
        assert hasattr(fftlab_torch, name), name


def test_plan_config_fields():
    cfg = PlanConfig()
    jcfg = JxPlanConfig()
    assert (cfg.flags, cfg.precision, cfg.leaf, cfg.algorithm) == (
        jcfg.flags, jcfg.precision, jcfg.leaf, jcfg.algorithm)
    assert cfg.dtype == torch.complex64 and PlanConfig(precision="f64").dtype == torch.complex128
    assert hash(PlanConfig(leaf=64)) == hash(PlanConfig(leaf=64))
