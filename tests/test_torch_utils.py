"""The port's utils (fftlab_torch.utils) against fftlab.utils: metrics,
signal file IO and the teaching visualizers on the same inputs, the
timing spans and the profiler trace.

Tolerances: the torch metrics of complex64 input within 2 float32 ulps
of the JAX ones (rtol 2.4e-7, atol 1e-30); the numpy metrics, the files
and the visualizers' text equal.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.utils as jx_utils
import fftlab_torch.utils as utils
from fftlab.utils import io as jx_io
from fftlab.utils import metrics as jx_metrics
from fftlab.utils import viz as jx_viz
from fftlab_torch.utils import io, metrics, trace, viz

REPO = Path(__file__).resolve().parent.parent
RTOL = 2 * np.finfo(np.float32).eps


def _complex(seed, n=257):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def test_exports_every_name_but_the_cpu_switch():
    want = {n for n in dir(jx_utils) if not n.startswith("_")} - {
        "prefer_cpu_for_complex", "compat"}
    missing = {n for n in want if not hasattr(utils, n)}
    assert not missing
    assert not hasattr(utils, "prefer_cpu_for_complex")


def test_new_modules_import_no_jax_or_fftlab():
    mods = ["fftlab_torch.native", "fftlab_torch.native.lib", "fftlab_torch.native.wav",
            "fftlab_torch.native.ring", "fftlab_torch.native.q15",
            "fftlab_torch.native.fft64", "fftlab_torch.algos.lowprec",
            "fftlab_torch.bench.harness", "fftlab_torch.utils", "fftlab_torch.utils.io",
            "fftlab_torch.utils.metrics", "fftlab_torch.utils.trace",
            "fftlab_torch.utils.viz", "fftlab_torch.cli.serve", "fftlab_torch.cli.bigfft",
            "fftlab_torch.cli.features", "fftlab_torch.cli.benchmark",
            "fftlab_torch.cli.analyzer"]
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in ('jax', 'triton', 'fftlab') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["magnitude", "phase", "power_spectrum_bins"])
@pytest.mark.parametrize("kind", ["complex", "real"])
def test_torch_metrics_match_jax(name, kind):
    x = _complex(1)
    if kind == "real":
        x = x.real.copy()
    got = getattr(metrics, name)(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(getattr(jx_metrics, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-30)
    np.testing.assert_array_equal(getattr(metrics, name)(x, device="cpu").numpy(),
                                  got.numpy())


def test_torch_metrics_need_the_card_for_numpy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.magnitude(np.ones(4))


def test_error_measures_match_jax():
    a, b = _complex(2), _complex(3)
    for name in ("max_error", "rms_error", "snr_db"):
        got = getattr(metrics, name)(a, b)
        assert got == getattr(jx_metrics, name)(a, b)
        assert getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b)) == got
    assert metrics.snr_db(a, a) == float("inf")


@pytest.mark.parametrize("lo,hi", [(1, None), (0, 3), (5, 40), (1, 0)])
def test_peak_and_centroid_match_jax(lo, hi):
    mag = np.abs(_complex(4, 128)).astype(np.float64)
    assert metrics.find_peak_interpolated(mag, lo, hi) == \
        jx_metrics.find_peak_interpolated(mag, lo, hi)
    assert metrics.find_peak_interpolated(torch.from_numpy(mag), lo, hi) == \
        jx_metrics.find_peak_interpolated(mag, lo, hi)
    assert metrics.spectral_centroid(mag, 8000.0, 128) == \
        jx_metrics.spectral_centroid(mag, 8000.0, 128)


# -- io ---------------------------------------------------------------------

@pytest.mark.parametrize("comment", ["", "a test signal"])
def test_text_file_bytes_equal_jax(tmp_path, comment):
    x = _complex(5, 33).astype(np.complex128)
    mine, theirs = tmp_path / "mine.txt", tmp_path / "theirs.txt"
    io.save_complex_signal(str(mine), x, comment)
    jx_io.save_complex_signal(str(theirs), x, comment)
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(io.load_complex_signal(str(theirs)),
                                  jx_io.load_complex_signal(str(theirs)))
    np.testing.assert_array_equal(io.load_complex_signal(str(mine)), x)


def test_text_file_from_a_tensor(tmp_path):
    x = _complex(6, 16)
    mine, theirs = tmp_path / "mine.txt", tmp_path / "theirs.txt"
    io.save_complex_signal(str(mine), torch.from_numpy(x))
    jx_io.save_complex_signal(str(theirs), x)
    assert mine.read_bytes() == theirs.read_bytes()


def test_text_file_errors(tmp_path):
    with pytest.raises(ValueError):
        io.save_complex_signal(str(tmp_path / "x.txt"), np.zeros((2, 2)))
    bad = tmp_path / "bad.txt"
    bad.write_text("# header\n0 1.0\n")
    with pytest.raises(ValueError):
        io.load_complex_signal(str(bad))


def test_npz_roundtrip_as_jax(tmp_path):
    re = np.arange(8, dtype=np.float32)
    im = -re
    io.save_signal_npz(str(tmp_path / "a.npz"), re=torch.from_numpy(re), im=im)
    jx_io.save_signal_npz(str(tmp_path / "b.npz"), re=re, im=im)
    got, want = io.load_signal_npz(str(tmp_path / "a.npz")), \
        jx_io.load_signal_npz(str(tmp_path / "b.npz"))
    assert set(got) == set(want) == {"re", "im"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_gnuplot_script_bytes_equal_jax(tmp_path):
    io.export_gnuplot_script(str(tmp_path / "a.gp"), "data.txt", title="T")
    jx_io.export_gnuplot_script(str(tmp_path / "b.gp"), "data.txt", title="T")
    assert (tmp_path / "a.gp").read_bytes() == (tmp_path / "b.gp").read_bytes()


# -- viz ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_butterfly_diagram_equal_jax(n):
    assert viz.butterfly_diagram(n) == jx_viz.butterfly_diagram(n)


@pytest.mark.parametrize("n", [2, 1024, 1 << 14, 1 << 20])
def test_memory_trace_and_tile_model_equal_jax(n):
    assert viz.memory_access_trace(n) == jx_viz.memory_access_trace(n)
    assert viz.simulate_tile_touches(n) == jx_viz.simulate_tile_touches(n)


@pytest.mark.parametrize("call", [lambda v: v.butterfly_diagram(12),
                                  lambda v: v.butterfly_diagram(64),
                                  lambda v: v.memory_access_trace(100),
                                  lambda v: v.simulate_tile_touches(100)])
def test_viz_refusals_as_jax(call):
    with pytest.raises(ValueError):
        call(viz)
    with pytest.raises(ValueError):
        call(jx_viz)


# -- trace ------------------------------------------------------------------

def test_timer_accumulates():
    t = trace.Timer()
    for _ in range(3):
        t.start()
        time.sleep(0.002)
        t.stop()
    assert len(t.laps) == 3 and t.total_s >= 0.006
    assert t.elapsed_ms == pytest.approx(t.total_s * 1e3)


def test_span_records_laps():
    timers = {}
    for _ in range(2):
        with trace.span("work", timers):
            time.sleep(0.002)
    with trace.span("cpu", timers, device="cpu"):
        torch.ones(8).sum()
    assert len(timers["work"].laps) == 2 and timers["work"].total_s >= 0.004
    assert len(timers["cpu"].laps) == 1


def test_span_records_when_the_block_raises():
    timers = {}
    with pytest.raises(KeyError):
        with trace.span("boom", timers):
            raise KeyError("x")
    assert len(timers["boom"].laps) == 1


def test_span_waits_only_for_a_card():
    assert trace._sync_device("cpu") is None
    assert trace._sync_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        assert trace._sync_device(None) is None


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from fftlab_torch.plan.api import plan_dft_1d_split

    plan = plan_dft_1d_split(1024, device="cpu")
    x = (torch.randn(2, 1024), torch.randn(2, 1024))
    with trace.profiler_trace(str(tmp_path / "log")) as prof:
        with trace.annotate("fftlab_region"):
            torch.fft.fft(torch.randn(4, 256, dtype=torch.complex64))
            plan.execute(x)
    path = tmp_path / "log" / trace.TRACE_FILE
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "fftlab_region" for e in events)
    assert any(e.key == "fftlab_region" for e in prof.key_averages())
    # fftlab's spans of the block, merged in as a process of their own,
    # inside the profiler's own range of the block
    pid = next(e["pid"] for e in events
               if e.get("ph") == "M" and e.get("args", {}).get("name") == "fftlab")
    ours = {e["name"]: e for e in events if e.get("pid") == pid and e.get("ph") == "X"}
    assert set(ours) >= {"execute", "dispatch", "wrapper"}
    region = next(e for e in events if e.get("name") == "fftlab_region" and "dur" in e)
    ex = ours["execute"]
    assert region["ts"] <= ex["ts"] and ex["ts"] + ex["dur"] <= region["ts"] + region["dur"]
