"""CPU tests of the yardstick and the harness.

    python -m pytest cellbench -q

The harness runs here on a copy of the benchmark whose configurations
and mixes are cut to a size the CPU holds (two rows; each configuration
at the least of n, n/2, n/4, ... at which the program still takes its
`route`); the program then runs each kernel's plain version, as it does
for a CPU tensor. Times read here are the CPU's and are never reported.

A configuration's `cpu_test`, read only here: `breaks`,
"<module>:<function>", the function under the entry that produces what
the timed path returns, which the fault tests replace.
"""

import hashlib
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from cellbench import compare, harness  # noqa: E402
from cellbench import trace as tr  # noqa: E402
from cellbench.reference import tf32  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**33 + 12345
# The single-row cells, out of BENCHMARK.json while the host's speed
# swings (PERF.md §7), and what they report: entries that bring them
# back with the files already in cellbench/.
SINGLE = {
    "workloads": [{"name": f"{c}.single", "config": c, "traffic": "single", "chips": 1,
                   "why": "one 2^20 row a call, a sync after each"}
                  for c in ("c2c_1m", "filter_1m")],
    "end_to_end": [{"name": "call_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "device_trace",
                    "workloads": ["c2c_1m.single", "filter_1m.single"]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower", "source": source,
                   "layer": layer, "moves": "call_ms_p95",
                   "workloads": ["c2c_1m.single", "filter_1m.single"]}
                  for name, unit, source, layer in (
                      ("host_us.single", "us", "program_span", "host path"),
                      ("launches.single", "1/call", "program_counter", "kernel wrappers"),
                      ("idle_pct.single", "%", "device_trace", "device"))],
}
ALL_CELLS = CELLS + [w["name"] for w in SINGLE["workloads"]]


def _cpu_test(cfg: dict) -> dict:
    """The configuration's `cpu_test`; a configuration without it is
    refused, never broken at a function guessed here."""
    if "cpu_test" not in cfg:
        raise ValueError(
            f"configuration {cfg.get('name')!r} has no \"cpu_test\" key: give it "
            f"{{\"breaks\": \"<module>:<function>\"}}")
    return cfg["cpu_test"]


def _breaks(cfg: dict) -> tuple:
    """(module, name) of the function the fault tests replace."""
    module, _, name = _cpu_test(cfg)["breaks"].partition(":")
    return importlib.import_module(module), name


def _north_star_db(kind: str) -> int:
    """ROADMAP's north star, SNR against a float64 oracle: above 120 dB,
    above 110 for r2c, c2r and STFT."""
    return 110 if kind.split("_")[0] in ("r2c", "c2r", "stft") else 120


def _checkout(root: Path, src: Path = ROOT) -> Path:
    """A copy in `root` of the benchmark at `src`: BENCHMARK.json and
    cellbench/ without its tests."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(src / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    return root


def _cpu_n(root: Path, bench: dict, entry: dict) -> int:
    """The least of n, n/2, n/4, ... (while whole) at which the program
    builds every cell of the configuration `entry` on its `route`."""
    cfg = harness.load_json(root / entry["file"])
    program = harness.load_module(root, "program", cfg["kind"])
    reference = harness.load_module(root, "reference", cfg["kind"])
    mixes = [harness.load_cell(root, w["name"]).traffic
             for w in bench["workloads"] if w["config"] == entry["name"]]
    sizes = [int(cfg["n"])]
    while sizes[-1] % 2 == 0:
        sizes.append(sizes[-1] // 2)
    for n in reversed(sizes):
        c = {**cfg, "n": n}
        consts = reference.make_constants(c, torch.Generator().manual_seed(0), "cpu")
        if all(program.build(c, t, consts, "cpu")[1] == cfg["route"] for t in mixes):
            return n
    raise ValueError(f"configuration {entry['name']!r}: the program takes route "
                     f"{cfg['route']!r} at none of n, n/2, n/4, ...")


def _small(root: Path, src: Path = ROOT) -> Path:
    """A copy in `root` of the benchmark at `src` with the single-row cells
    added, every mix at two rows or fewer and each configuration at the
    least size on its route (`_cpu_n`)."""
    _checkout(root, src)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in SINGLE.items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in (root / "cellbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(rows=min(t["rows"], 2), pool_calls=2, check_calls=2, slice_calls=3,
                 slice_warm_calls=1)
        f.write_text(json.dumps(t))
    sizes = {e["file"]: _cpu_n(root, bench, e) for e in bench["configs"]}
    for file, n in sizes.items():
        cfg = harness.load_json(root / file)
        (root / file).write_text(json.dumps({**cfg, "n": n}))
    return root


@pytest.fixture(scope="module", autouse=True)
def _threads_shared_among_workers():
    """Each pytest-xdist worker takes its share of torch's threads. Four
    workers each at the default, one thread a core, ran a single-row call
    some 70 times slower than one process did, fewer than the two calls a
    synced mix's p95 needs in a 0.2 s window."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _small(tmp_path_factory.mktemp("small"))


def _run(root, cell, **kw):
    kw.setdefault("seconds", 0.2)
    return harness.run_cell(cell, SEED, kw.pop("seconds"), kw.pop("trace", False), "cpu",
                            root=root, log=lambda s: None, **kw)


# -- the work counts: inputs read once, outputs written once -------------

@pytest.mark.parametrize("cell, nbytes, flops", [
    ("c2c_1m.bulk16", 16 * 2**20 * 16, 5 * 16 * 2**20 * 20),
    ("filter_1m.bulk16", 16 * 2**20 * 16 + 8 * 2**20, 2 * 5 * 16 * 2**20 * 20 + 6 * 16 * 2**20),
    ("c2c_1m.single", 2**20 * 16, 5 * 2**20 * 20),
    ("filter_1m.single", 2**20 * 16 + 8 * 2**20, 2 * 5 * 2**20 * 20 + 6 * 2**20),
])
def test_work_counts(cell, nbytes, flops):
    config, mix = cell.split(".")
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    w = harness.load_module(ROOT, "work", cfg["kind"]).work(cfg, traffic)
    assert w == {"bytes": nbytes, "flops": flops}


def test_headline_least_times():
    """16 x 2^20 c2c: 268 MB over 3.35 TB/s, 0.0801 ms; the sandwich adds H."""
    peaks = json.loads((HERE / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    c = harness.load_cell(ROOT, "c2c_1m.bulk16")
    w = harness.load_module(ROOT, "work", "c2c").work(c.config, c.traffic)
    assert w["bytes"] / peaks["bytes_per_s"] == pytest.approx(80.13e-6, rel=1e-3)
    assert w["flops"] / peaks["flops_per_s"] < w["bytes"] / peaks["bytes_per_s"]


# -- the readers, on a slice of known intervals ---------------------------

def _slice():
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [x("kernel", "void fftlab::fourstep_pass1_kernel<0, 10>(float const*, int)",
                1010.0, 20.0),
              x("kernel", "void fftlab::fourstep_pass2_kernel<0, 10>(float const*)", 1025.0, 15.0),
              x("kernel", "void fftlab::fourstep_pass1_kernel<0, 10>(float const*, int)",
                1060.0, 10.0),
              x("gpu_memset", "Memset (Device)", 1080.0, 5.0),
              x("kernel", "outside", 2000.0, 5.0),
              x("cuda_runtime", "cudaLaunchKernel", 1001.0, 1.0)]
    spans = [("sync", 1050.0, 1100.0), ("entry", 1000.0, 1050.0)]
    return tr.read_slice(events, 2, 1000.0, 1100.0, spans)


def test_slice_union_idle_and_device_time():
    sl = _slice()
    assert sl.window_us == 100.0 and len(sl.device_ops) == 4
    assert tr.busy_intervals(sl) == [(1010.0, 1040.0), (1060.0, 1070.0), (1080.0, 1085.0)]
    assert tr.busy_us(sl) == 45.0
    assert tr.idle_share(sl) == pytest.approx(0.55)
    assert tr.device_us_per_call(sl) == pytest.approx(25.0)
    ops = dict(tr.device_ops_by_name(sl))
    assert ops["fourstep_pass1_kernel<0, 10>"] == pytest.approx(30e-6)
    assert ops["fourstep_pass2_kernel<0, 10>"] == pytest.approx(15e-6)
    gaps = dict(tr.idle_gaps_by_span(sl))
    assert gaps["entry"] == pytest.approx(10e-6)
    assert gaps["sync"] == pytest.approx(45e-6)


def test_trace_clock():
    assert tr.trace_us(1_790_000_000_123_456_000, 1_790_000_000_000_000_000) == 123456.0


def test_readers_by_name():
    sl = _slice()
    work = {"bytes": 3.35e6, "flops": 1.0}  # 1 us at 3.35 TB/s
    rec = harness.Record(work, {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}, 4,
                         [3e-6, 1e-6, 2e-6], {"fourstep_pass1": 4, "fourstep_pass2": 4}, sl)
    read = lambda name: harness.load_module(ROOT, "metrics", name).read(rec)
    assert read("transform_roofline.bulk") == pytest.approx(100 * 1.0 / 25.0)
    assert read("idle_pct.bulk") == pytest.approx(55.0)
    assert read("idle_pct.single") == pytest.approx(55.0)
    assert read("host_us.single") == pytest.approx(2.0)
    assert read("launches.single") == read("launches.bulk") == 2.0


def test_readers_give_nothing_without_a_trace():
    empty = tr.Slice(0.0, 10.0, 2, [], [])
    rec = harness.Record({"bytes": 1, "flops": 1}, None, 0, [], {}, empty)
    for m in BENCH["per_layer"] + SINGLE["per_layer"]:
        assert harness.load_module(ROOT, "metrics", m["name"]).read(rec) is None, m["name"]


@pytest.mark.parametrize("raw, short", [
    ("void fftlab::fourstep_pass2_sandwich_kernel<4, 10>(float*, float*, fftlab::Geometry)",
     "fourstep_pass2_sandwich_kernel<4, 10>"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"),
    ("plain_kernel", "plain_kernel"),
])
def test_short_kernel_name(raw, short):
    assert tr.short_kernel_name(raw) == short


# -- the reference and the control ---------------------------------------

def _planes(rows, n, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)))


@pytest.mark.parametrize("n", [2, 16, 256, 4096])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_c2c_reference_is_numpy(n, direction):
    ref = harness.load_module(ROOT, "reference", "c2c")
    xr, xi = _planes(3, n)
    x = xr.numpy().astype(np.float64) + 1j * xi.numpy().astype(np.float64)
    want = np.fft.fft(x) if direction == "forward" else np.fft.ifft(x)
    got = ref.reference(xr, xi, {}, {"n": n}, direction).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * n)
    if n <= 256:  # the definition itself
        k = np.arange(n)
        sign = -1 if direction == "forward" else 1
        dft = np.exp(sign * 2j * np.pi * np.outer(k, k) / n) @ x.T
        np.testing.assert_allclose(got, (dft if sign < 0 else dft / n).T, atol=1e-9 * n)


def test_filter_reference_is_numpy():
    ref = harness.load_module(ROOT, "reference", "filter")
    n = 1024
    g = torch.Generator().manual_seed(5)
    consts = ref.make_constants({"n": n}, g, "cpu")
    h = consts["hr"].double().numpy() + 1j * consts["hi"].double().numpy()
    assert abs(np.mean(np.abs(h) ** 2) - 1) < 0.15  # E|H|^2 = 1
    xr, xi = _planes(2, n)
    x = xr.numpy().astype(np.float64) + 1j * xi.numpy().astype(np.float64)
    want = np.fft.ifft(np.fft.fft(x) * h)
    np.testing.assert_allclose(ref.reference(xr, xi, consts, {"n": n}, "forward").numpy(),
                               want, atol=1e-12)
    with pytest.raises(ValueError):
        ref.reference(xr, xi, consts, {"n": n}, "inverse")


def test_tf32_rounding():
    x = torch.randn(10000) * 1e3
    r = tf32.to_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)  # a 10-bit mantissa
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 2**-13 < rel <= 2**-11
    assert torch.equal(tf32.to_tf32(r), r)


@pytest.mark.parametrize("kind", ["c2c", "filter"])
def test_control_is_tf32_and_fails_the_contract(kind):
    """The control's SNR: TF32's, far below the 120 dB contract and far
    above noise, at the cells' shape (n = 2^20) cut to n = 2^12."""
    ref = harness.load_module(ROOT, "reference", kind)
    n = 4096
    consts = ref.make_constants({"n": n}, torch.Generator().manual_seed(1), "cpu")
    xr, xi = _planes(2, n)
    yr, yi = ref.control(xr, xi, consts, {"n": n}, "forward")
    snr = compare.row_snr_db(yr, yi, ref.reference(xr, xi, consts, {"n": n}, "forward"))
    assert all(50 < s < 90 for s in snr), snr


def test_row_snr():
    want = torch.complex(*(t.double() for t in _planes(2, 64)))
    yr, yi = want.real.float(), want.imag.float()
    assert min(compare.row_snr_db(yr, yi, want)) > 130
    assert compare.row_snr_db(want.real.double(), want.imag.double(), want) == [400.0] * 2
    bad = yr.clone()
    bad[1, 3] = float("nan")
    s = compare.row_snr_db(bad, yi, want)
    assert s[0] > 130 and math.isnan(s[1])
    bad[1, 3] = float("inf")
    assert compare.row_snr_db(bad, yi, want)[1] == -math.inf
    assert compare.row_snr_db(yr[:1], yi[:1], want) == [-math.inf, -math.inf]


# -- BENCHMARK.json ------------------------------------------------------

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def _names_and_units(bench: dict):
    metrics = bench["end_to_end"] + bench["per_layer"]
    cells = [w["name"] for w in bench["workloads"]]
    names = [m["name"] for m in metrics] + cells + [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in bench["configs"]] + [c["why"] for c in bench["configs"]]
                 + [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_names_and_units():
    _names_and_units(BENCH)


def _hangs_together(root: Path):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in [w["name"] for w in bench["workloads"]]:
        c = harness.load_cell(root, cell)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported, (cell, m["name"])
        for m in c.end_to_end + c.per_layer:
            assert harness.NAME.match(m["name"])
        for m in c.per_layer:
            assert (root / "cellbench" / "metrics" / f"{m['name']}.py").is_file()
        cfg = next(x for x in bench["configs"] if x["name"] == c.config["name"])
        assert cfg["reduced"] == c.config["reduced"]
        assert cfg["source"] == c.config["source"]


def test_cells_and_metrics_hang_together():
    _hangs_together(ROOT)


@pytest.mark.parametrize("file", [c["file"] for c in BENCH["configs"]])
def test_each_configuration_names_its_cpu_test(file):
    cfg = json.loads((ROOT / file).read_text())
    t = _cpu_test(cfg)
    assert set(t) == {"breaks"}, t
    module, name = _breaks(cfg)
    assert callable(getattr(module, name, None)), t["breaks"]


def test_a_configuration_without_cpu_test_is_refused(tmp_path, monkeypatch):
    src = _checkout(tmp_path / "src")
    cfg = src / "cellbench" / "configs" / "c2c_1m.json"
    cfg.write_text(json.dumps({k: v for k, v in json.loads(cfg.read_text()).items()
                               if k != "cpu_test"}))
    small = _small(tmp_path / "small", src)
    with pytest.raises(ValueError, match="'c2c_1m' has no \"cpu_test\" key"):
        _broken_is_not_correct(small, "c2c_1m.bulk16", "unchanged", monkeypatch)


# -- the harness on the CPU ----------------------------------------------

def _is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    c = harness.load_cell(root, cell)
    check = r["checks"]["worst_row_snr_db"]
    assert list(r)[-1] == "checks" and check["limit"] >= _north_star_db(c.config["kind"])
    assert check["value"] > check["limit"]
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}


def _traced_is_correct(root, cell):
    r = _run(root, cell, trace=True)
    assert r["correct"]
    c = harness.load_cell(root, cell)
    assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    if cell.endswith(".single"):
        assert r["metrics"]["host_us.single"]["value"] > 0


def _control_is_not_correct(root, cell):
    r = _run(root, cell, control=True)
    assert not r["correct"]
    assert 50 < r["checks"]["worst_row_snr_db"]["value"] < 90


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_program_is_correct(small, cell):
    _is_correct(small, cell)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_traced_run(small, cell):
    _traced_is_correct(small, cell)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_is_not_correct(small, cell):
    _control_is_not_correct(small, cell)


def _input_planes(args):
    """The entry's input planes: (xr, xi), or one real plane beside zeros."""
    x = args[0]
    if len(args) > 1 and torch.is_tensor(args[1]) and args[1].shape == x.shape:
        return x, args[1]
    return x, torch.zeros_like(x)


def _unchanged(*a, **k):
    return _input_planes(a)


def _half_batch(run):
    def fault(*a, **k):
        yr, yi = run(*a, **k)
        yr, yi = yr.clone(), yi.clone()
        yr[yr.shape[0] // 2:], yi[yi.shape[0] // 2:] = 0, 0
        return yr, yi
    return fault


def _altered(run):
    def fault(*a, **k):
        yr, yi = run(*a, **k)
        yr = yr.clone()
        yr[..., 1] = 0
        return yr, yi
    return fault


FAULTS = ["unchanged", "half_batch", "altered"]


def _applies(root, cell, fault) -> bool:
    return fault != "half_batch" or harness.load_cell(root, cell).traffic["rows"] > 1


def _broken_is_not_correct(root, cell, fault, monkeypatch):
    """The function the configuration's `cpu_test.breaks` names, replaced
    by `fault`."""
    module, name = _breaks(harness.load_cell(root, cell).config)
    run = getattr(module, name)
    broken = {"unchanged": _unchanged, "half_batch": _half_batch(run),
              "altered": _altered(run)}[fault]
    monkeypatch.setattr(module, name, broken)
    r = _run(root, cell)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_program_is_not_correct(small, cell, fault, monkeypatch):
    """The timed path broken underneath the entry: a transform that returns
    its input unchanged, one that leaves half the batch out, one that
    alters an answer where it is produced. (One card: no exchange between
    cards to leave out.)"""
    if not _applies(small, cell, fault):
        pytest.skip("a single-row mix has no half batch to leave out")
    _broken_is_not_correct(small, cell, fault, monkeypatch)


def test_refusals(small, monkeypatch):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", "einsum")
    with pytest.raises(harness.BenchError, match="FFTLAB_FORCE_IMPL"):
        _run(small, "c2c_1m.bulk16")
    monkeypatch.delenv("FFTLAB_FORCE_IMPL")
    cfg = small / "cellbench" / "configs" / "c2c_1m.json"
    old = cfg.read_text()
    try:
        cfg.write_text(json.dumps({**json.loads(old), "n": 2**13}))  # the row kernel's window
        with pytest.raises(harness.BenchError, match="route"):
            _run(small, "c2c_1m.bulk16")
    finally:
        cfg.write_text(old)
    with pytest.raises(harness.BenchError, match="no workload"):
        _run(small, "nothing.here")


def test_foreign_modules():
    assert harness.foreign_modules({"jax.numpy": 1, "fftlab_torch": 1}) == ["jax"]
    assert harness.foreign_modules({"fftlab.plan": 1, "jaxtyping": 1, "flax": 1}) == [
        "fftlab", "flax"]
    assert harness.foreign_modules({"fftlab_torch.kernels": 1, "cellbench": 1}) == []


def test_run_needs_a_card():
    """Without a card (this machine) run.py prints no result and fails."""
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "c2c_1m.bulk16",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


# -- a new configuration, mix or metric is new files only ----------------

def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "cellbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    root = _small(tmp_path)
    before = _digests(root)
    d = root / "cellbench"
    cfg = json.loads((d / "configs" / "c2c_1m.json").read_text())
    (d / "configs" / "c2c_32k.json").write_text(json.dumps(
        {**cfg, "name": "c2c_32k", "n": 2**15, "direction_note": "a new configuration"}))
    (d / "traffic" / "burst3.json").write_text(json.dumps(
        {"name": "burst3", "rows": 3, "pattern": "pipelined", "pool_calls": 2,
         "direction": "inverse", "check_calls": 2, "slice_calls": 2, "slice_warm_calls": 1}))
    (d / "metrics" / "calls_seen.burst.py").write_text(
        "def read(record):\n    return float(record.calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "c2c_32k", "source": cfg["source"],
                             "file": "cellbench/configs/c2c_32k.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": "c2c_32k.burst3", "config": "c2c_32k",
                               "traffic": "burst3", "chips": 1, "why": "a new cell"})
    bench["end_to_end"][0]["workloads"].append("c2c_32k.burst3")
    bench["per_layer"].append({"name": "calls_seen.burst", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "gsamples_per_s", "workloads": ["c2c_32k.burst3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r = _run(root, "c2c_32k.burst3")
    assert r["correct"] and set(r["metrics"]) == {"gsamples_per_s", "setup_s"}
    r = _run(root, "c2c_32k.burst3", trace=True)
    assert r["correct"] and r["metrics"]["calls_seen.burst"]["value"] == r["attempted"]
    after = _digests(root)
    assert {k: after[k] for k in before} == before  # no file that was there changed


# A test-only kind, r2c_probe, as a configuration that brings a kind
# would: its program, reference and work count are new files, found by
# the kind's name. The probes' names are their own, and `_join` takes the
# next free one where a name is already there, so that no cell a later
# change adds can meet a probe.
R2C_PROGRAM = '''"""The r2c cells' entry into fftlab_torch: a real-to-complex plan made
with the ESTIMATE flags, executed on each call's real plane."""


def build(config, traffic, consts, device):
    """(call, route): call(xr, xi) -> (yr, yi), the n/2+1 one-sided bins
    of xr (xi, which the harness draws for every kind, is not read)."""
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
'''

R2C_REFERENCE = '''"""Plain reference of the batched r2c FFT: torch.fft.rfft in complex128
on the real float32 plane, its n/2+1 one-sided bins. The control is the
first n/2+1 bins of the c2c transform in TF32 with a zero imaginary
plane."""

import torch

from cellbench.reference.tf32 import dft_tf32


def make_constants(config, gen, device):
    return {}


def _forward_only(direction):
    if direction != "forward":
        raise ValueError(f"an r2c runs forward; got direction {direction!r}")


def reference(xr, xi, consts, config, direction):
    """complex128 [rows, n/2+1]."""
    _forward_only(direction)
    return torch.fft.rfft(xr.double())


def control(xr, xi, consts, config, direction):
    """float32 planes [rows, n/2+1] of the same transform in TF32."""
    _forward_only(direction)
    yr, yi = dft_tf32(xr, torch.zeros_like(xr))
    h = xr.shape[-1] // 2 + 1
    return yr[..., :h], yi[..., :h]
'''

R2C_WORK = '''"""Work of one call of a batched r2c FFT: n real float32 samples read
and n/2+1 complex bins written a row (8n + 8 bytes), and benchFFT's
2.5 n log2 n flops a row."""

import math


def work(config, traffic):
    n, rows = int(config["n"]), int(traffic["rows"])
    return {"bytes": rows * (8 * n + 8), "flops": rows * 5 * n * int(math.log2(n)) // 2}
'''

PROBES = {
    # a new kind on a route of its own
    "new_kind": {
        "config": {"name": "r2c_probe", "kind": "r2c_probe", "n": 2**21,
                   "route": "rfft_resident",
                   "cpu_test": {"breaks": "fftlab_torch.kernels.rfft_resident:rfft_resident"},
                   "source": "fftlab bench.py bench_rfft (:755): 8 x 2^21 real rows",
                   "contract": {"worst_row_snr_db": 110},
                   "contract_why": "ROADMAP north star: above 110 dB for r2c/c2r and STFT",
                   "reduced": []},
        "traffic": {"name": "probe8", "rows": 8, "pattern": "pipelined", "pool_calls": 4,
                    "direction": "forward", "check_calls": 8, "slice_calls": 256,
                    "slice_warm_calls": 4},
        "files": {"program": R2C_PROGRAM, "reference": R2C_REFERENCE, "work": R2C_WORK},
        "work": {"bytes": 8 * (8 * 2**21 + 8), "flops": 8 * 5 * 2**21 * 21 // 2},
    },
    # a second route of a kind already there
    "new_route": {
        "config": {"name": "c2c_probe", "kind": "c2c", "n": 2**24, "route": "three_pass",
                   "cpu_test": {"breaks": "fftlab_torch.kernels.threestep_vmem:fft_split_huge"},
                   "source": "fftlab bench.py (:479): 1 x 2^24 c2c on the three-pass route",
                   "contract": {"worst_row_snr_db": 120},
                   "contract_why": "ROADMAP north star: above 120 dB for the c2c kernels",
                   "reduced": []},
        "traffic": {"name": "probe1", "rows": 1, "pattern": "pipelined", "pool_calls": 2,
                    "direction": "forward", "check_calls": 4, "slice_calls": 64,
                    "slice_warm_calls": 4},
        "files": {},
        "work": {"bytes": 16 * 2**24, "flops": 5 * 2**24 * 24},
    },
}


def _fresh(name: str, taken: set) -> str:
    """`name`, or `name` with the least of _2, _3, ... that is not taken."""
    k, fresh = 1, name
    while fresh in taken:
        k += 1
        fresh = f"{name}_{k}"
    return fresh


def _join(src: Path, probe: dict) -> str:
    """`probe` added to the benchmark at `src` as a later change adds a
    configuration: new files and appended entries, each under a name that
    is not yet taken there. Returns the new cell's name."""
    d = src / "cellbench"
    stems = lambda *folders: {f.stem for x in folders for f in (d / x).iterdir()}
    bench = json.loads((src / "BENCHMARK.json").read_text())
    config = _fresh(probe["config"]["name"],
                    stems("configs") | {c["name"] for c in bench["configs"]})
    mix = _fresh(probe["traffic"]["name"], stems("traffic"))
    kind = probe["config"]["kind"]
    if probe["files"]:
        kind = _fresh(kind, stems(*probe["files"]))
        for folder, text in probe["files"].items():
            (d / folder / f"{kind}.py").write_text(text)
    cell = f"{config}.{mix}"
    (d / "configs" / f"{config}.json").write_text(
        json.dumps({**probe["config"], "name": config, "kind": kind}))
    (d / "traffic" / f"{mix}.json").write_text(json.dumps({**probe["traffic"], "name": mix}))
    bench["configs"].append({"name": config, "source": probe["config"]["source"],
                             "file": f"cellbench/configs/{config}.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("probe, names_taken", [
    ("new_kind", False), ("new_kind", True), ("new_route", False)])
def test_a_new_kind_joins_with_new_files(tmp_path, probe, names_taken, monkeypatch):
    """A configuration, mix and kind added as a later change adds them:
    new files and appended entries in a copy of the benchmark, and not a
    byte of a file that was there. The new cell then passes every check
    the cells above pass, at the least size on its route and with its own
    function broken. With `names_taken`, the copy already holds a cell,
    configuration, mix and kind of the probe's names, as after a later
    change that took them."""
    src = _checkout(tmp_path / "src")
    if names_taken:
        taken = _join(src, PROBES[probe])
    before = _digests(src)
    cell = _join(src, PROBES[probe])
    after = _digests(src)
    assert {k: after[k] for k in before} == before  # no file that was there changed
    if names_taken:
        assert cell != taken
    _names_and_units(json.loads((src / "BENCHMARK.json").read_text()))
    _hangs_together(src)
    c = harness.load_cell(src, cell)
    assert harness.load_module(src, "work", c.config["kind"]).work(c.config, c.traffic) \
        == PROBES[probe]["work"]

    small = _small(tmp_path / "small", src)
    if names_taken:
        _is_correct(small, taken)
    _is_correct(small, cell)
    _traced_is_correct(small, cell)
    _control_is_not_correct(small, cell)
    for fault in FAULTS:
        if _applies(small, cell, fault):
            with monkeypatch.context() as mp:
                _broken_is_not_correct(small, cell, fault, mp)
