"""The port's entry points on the CPU: `fftlab_torch.entry` (the
flagship forward against __graft_entry__'s on the same inputs, >= 120
dB; `dryrun_multichip` over 2 and 4 gloo ranks of one world of four,
through tests/_torch_dist_worker.py, and at world 1 in this process), the nine
algorithm module demos in-process, the quickstart menu and the minimal
example (as tests/test_cli.py:40-53 runs the JAX ones)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jx_entry
from _torch_dist_worker import run_ranks
from _torch_parity import cplx, planes, snr_db, tt
from fftlab_torch import entry


def test_entry_matches_the_graft_entry():
    fn, args = entry.entry(device="cpu")
    jfn, jargs = jx_entry.entry()
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    assert all(a.device.type == "cpu" and a.dtype == torch.float32 for a in args)
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    got = cplx(*fn(*args))
    want = cplx(*jax.jit(jfn)(*jargs))
    assert snr_db(got, want) >= 120.0
    # and on inputs with something to filter
    xr, xi = planes(1, (8, 16384))
    hr, hi = planes(2, 16384)
    got = cplx(*fn(tt(xr), tt(xi), tt(hr), tt(hi)))
    want = cplx(*jax.jit(jfn)(*(jnp.asarray(a) for a in (xr, xi, hr, hi))))
    assert snr_db(got, want) >= 120.0


def test_entry_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke phase 4i runs entry() there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


@pytest.fixture(scope="module")
def dryrun_res(tmp_path_factory):
    """One world of four gloo ranks runs `dryrun_multichip(2)`, then
    `dryrun_multichip(4)`."""
    return run_ranks("entry", 4, tmp_path_factory.mktemp("entry"))


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_over_gloo(dryrun_res, world):
    case = f"dryrun_{world}"
    assert f"{case}/error" not in dryrun_res, dryrun_res.get(f"{case}/error")
    assert int(dryrun_res[f"{case}/n_devices"]) == world
    assert int(dryrun_res[f"{case}/world"]) == 4


def test_entry_main_at_world_one(capsys):
    entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry OK: [(8, 16384), (8, 16384)]" in out
    assert "dryrun_multichip(1) OK" in out
    assert not torch.distributed.is_initialized()


DEMOS = [("bluestein", "bluestein_fft", {}), ("dft", "naive_dft", {"sizes": (16, 64, 256)}),
         ("iterative", "iterative_fft", {}), ("mixed_radix", "mixed_radix_fft", {}),
         ("radix2", "radix2_dit", {}), ("radix4", "radix4_fft", {}),
         ("recursive", "recursive_fft", {}), ("split_radix", "split_radix_fft", {}),
         ("stockham", "stockham_fft", {})]


@pytest.mark.parametrize("module,fn,kw", DEMOS, ids=[d[0] for d in DEMOS])
def test_module_demo_passes(capsys, module, fn, kw):
    from fftlab_torch.algos._common import run_module_demo

    mod = importlib.import_module(f"fftlab_torch.algos.{module}")
    run_module_demo(fn, getattr(mod, fn), device="cpu", **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "roundtrip" in ln]
    assert len(lines) == 3 and all("PASS" in ln for ln in lines)


def test_module_demo_fails_loudly(capsys):
    from fftlab_torch.algos._common import run_module_demo
    from fftlab_torch.algos.radix2 import radix2_dit

    with pytest.raises(SystemExit) as e:
        run_module_demo("scaled", lambda x, d: radix2_dit(x, d) * 1.001, sizes=(64,),
                        device="cpu")
    assert e.value.code == 1
    assert "FAIL" in capsys.readouterr().out


def test_module_demo_has_every_jax_demo():
    """Each JAX module with a demo main has one in the port, taking
    `--device` as the cli demos do."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for module, _, _ in DEMOS:
        src = (root / "fftlab_torch" / "algos" / f"{module}.py").read_text()
        tail = [n for n in ast.parse(src).body if isinstance(n, ast.If)]
        assert tail and "demo_device()" in ast.unparse(tail[-1]), module


def test_demo_device_parses_like_the_cli():
    from fftlab_torch.algos._common import demo_device

    assert demo_device(["--device", "cpu"]) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo_device([])


def test_quickstart_menu_lists(capsys, monkeypatch):
    from fftlab_torch import quickstart

    quickstart.show_menu()
    out = capsys.readouterr().out
    assert "fftlab_torch quickstart" in out and "benchmark" in out.lower()
    assert all(cmd[1:3] == ["-m", "fftlab_torch.examples.minimal"] or "fftlab_torch" in
               " ".join(cmd) or "pytest" in cmd for _, cmd in quickstart.MENU)
    assert not any("bench.py" in " ".join(cmd) for _, cmd in quickstart.MENU)
    ran = []
    monkeypatch.setattr(quickstart, "run", lambda i: ran.append(i) or 0)
    monkeypatch.setattr("sys.argv", ["quickstart", "all"])
    quickstart.main()
    assert ran == list(range(1, len(quickstart.MENU)))  # all but the tests


def test_minimal_example(capsys):
    from fftlab_torch.examples import minimal

    minimal.main(device="cpu")
    out = capsys.readouterr().out
    assert "self-test passed: X[k] = W_8^k" in out
    assert len(out.splitlines()) == minimal.N + 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            minimal.main()
