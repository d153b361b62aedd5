"""The port's DSP demos (`python -m fftlab_torch.cli.<demo>`): each runs
in-process with `--device cpu`, and what it prints agrees with the JAX
demo's on the same arguments (tests/test_cli.py's): the same lines and
words, every printed number within one unit in its last printed place,
every ASCII bar within one character, every ASCII-image character within
one step of the ramp. The convolution demo's residuals (max errors vs
the direct convolution and numpy) are rounding noise of float64 on both
sides, so there both must stay under the demo's own float64 bound, 1e-8.
Without `--device`, a demo runs on the card and raises where there is
none; `--wav` (the native WAV reader, not ported) exits non-zero."""

import contextlib
import importlib
import io
import re
import sys

import pytest
import torch

ARGS = {
    "pitch": ["--freqs", "220,440"],
    "filter": ["--n", "1024"],
    "image": ["--size", "32"],
    "spectrum": ["--n", "4096"],
    "convolution": ["--nx", "1024", "--nh", "33"],
    "analyzer": ["--frames", "1", "--fft-size", "512", "--hop", "128"],
}
RAMP = " .:-=+*#%@"
NUMBER = re.compile(r"[-+]?\d+(?:\.(\d+))?(?:e([-+]?\d+))?")


def run(module: str, argv: list[str]) -> str:
    old = sys.argv
    sys.argv = ["prog"] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            importlib.import_module(module).main()
    finally:
        sys.argv = old
    return out.getvalue()


def numbers_agree(a: str, b: str, residual: bool) -> None:
    """The same words around the numbers, each number within one unit in
    its last printed place (under 1e-8 both, for a residual)."""
    assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
    for ma, mb in zip(NUMBER.finditer(a), NUMBER.finditer(b)):
        x, y = float(ma.group(0)), float(mb.group(0))
        if residual and "e" in ma.group(0):
            assert x < 1e-8 and y < 1e-8, (a, b)
            continue
        unit = 10.0 ** (-len(ma.group(1) or "") + int(ma.group(2) or 0))
        assert abs(x - y) <= unit * (1 + 1e-9), (a, b)


def lines_agree(a: str, b: str) -> None:
    if a and set(a) <= set(RAMP) and set(b) <= set(RAMP):  # an ASCII image row
        assert len(a) == len(b)
        assert all(abs(RAMP.index(p) - RAMP.index(q)) <= 1 for p, q in zip(a, b)), (a, b)
    elif "|" in a:  # an ASCII bar: "label |####"
        (la, ba), (lb, bb) = a.split("|", 1), b.split("|", 1)
        numbers_agree(la, lb, False)
        assert set(ba) <= {"#"} and set(bb) <= {"#"} and abs(len(ba) - len(bb)) <= 1, (a, b)
    else:
        numbers_agree(a, b, residual="max err" in a)


@pytest.mark.parametrize("demo", list(ARGS))
def test_demo_agrees_with_jax(demo):
    want = run(f"fftlab.cli.{demo}", ARGS[demo])
    got = run(f"fftlab_torch.cli.{demo}", ARGS[demo] + ["--device", "cpu"])
    assert len(got) > 50
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for a, b in zip(got_lines, want_lines):
        lines_agree(a, b)


def test_numbers_agree_checks_the_last_place():
    numbers_agree("gain 1.00, 3.5e-02", "gain 1.01, 3.6e-02", False)
    with pytest.raises(AssertionError):
        numbers_agree("lag 128 (~8.0 Hz)", "lag 128 (~8.2 Hz)", False)
    with pytest.raises(AssertionError):
        lines_agree(" .:-=", " .:-@")


@pytest.mark.parametrize("demo", list(ARGS))
def test_demo_without_device_needs_the_card(monkeypatch, demo):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(f"fftlab_torch.cli.{demo}", ARGS[demo])


def test_analyzer_wav_exits_nonzero_naming_the_item(tmp_path):
    with pytest.raises(SystemExit) as exc:
        run("fftlab_torch.cli.analyzer", ["--wav", str(tmp_path / "a.wav"), "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert "ROADMAP Queue 1 item 13" in str(exc.value.code)


def test_the_port_has_no_cpu_fallback():
    """The JAX demos' `prefer_cpu_for_complex` moves JAX to the CPU; the
    port has no such call anywhere."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    hits = [str(p) for p in (root / "fftlab_torch").rglob("*.py")
            if "prefer_cpu_for_complex" in p.read_text()]
    assert not hits
