"""The port's DSP demos (`python -m fftlab_torch.cli.<demo>`): each runs
in-process with `--device cpu`, and what it prints agrees with the JAX
demo's on the same arguments (tests/test_cli.py's): the same lines and
words, every printed number within one unit in its last printed place,
every ASCII bar within one character, every ASCII-image character within
one step of the ramp. The convolution demo's residuals (max errors vs
the direct convolution and numpy) are rounding noise of float64 on both
sides, so there both must stay under the demo's own float64 bound, 1e-8.
Without `--device`, a demo runs on the card and raises where there is
none.

The demos of the single-card edges are held to their JAX demos on the
same input: `serve`'s output WAV within 1 PCM16 LSB of fftlab.cli.serve's
and its printed attenuations within 0.1 dB; `analyzer --wav` line by line
as above; `features`' algorithm choices and teaching text equal;
`benchmark --json` with JAX's keys and rows, and the card's name added;
`bigfft` at its own gates (>= 120 dB against float64, the split
convolution within 1e-4 of np.convolve)."""

import contextlib
import importlib
import io
import re
import sys

import numpy as np
import pytest
import torch

from _torch_parity import jax_native

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
    """`--wav` of a file that is not there fails, naming the file (the
    native reader's OSError, as in the JAX demo)."""
    with pytest.raises(OSError, match="a.wav"):
        run("fftlab_torch.cli.analyzer", ["--wav", str(tmp_path / "a.wav"), "--device", "cpu"])


def test_the_port_has_no_cpu_fallback():
    """The JAX demos' `prefer_cpu_for_complex` moves JAX to the CPU; the
    port has no such call anywhere."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    hits = [str(p) for p in (root / "fftlab_torch").rglob("*.py")
            if "prefer_cpu_for_complex" in p.read_text()]
    assert not hits


# -- the single-card edges ----------------------------------------------------

def _two_tone_wav(path, fs=16000, seconds=4, channels=1):
    """The JAX serve demo's own input (440 Hz + 6 kHz), written by the JAX
    writer."""
    from fftlab.native.wav import write_wav

    jax_native()
    t = np.arange(fs * seconds) / fs
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.4 * np.sin(2 * np.pi * 6000 * t)).astype(np.float32)
    if channels == 2:
        sig = np.stack([sig, 0.5 * sig], axis=1)
    write_wav(str(path), sig, fs)


def test_serve_agrees_with_jax(tmp_path):
    from fftlab.native.wav import read_wav

    _two_tone_wav(tmp_path / "in.wav")
    common = ["--in", str(tmp_path / "in.wav"), "--taps", "65", "--chunk", "16384"]
    want = run("fftlab.cli.serve", common + ["--out", str(tmp_path / "jax.wav")])
    got = run("fftlab_torch.cli.serve",
              common + ["--out", str(tmp_path / "port.wav"), "--device", "cpu"])
    a, fa = read_wav(str(tmp_path / "port.wav"))
    b, fb = read_wav(str(tmp_path / "jax.wav"))
    assert fa == fb and a.shape == b.shape == (64000,)
    assert np.max(np.abs(a - b)) <= 1.0 / 32768 + 1e-9
    tones = [line for line in got.splitlines() if line.strip().endswith("dB")]
    jtones = [line for line in want.splitlines() if line.strip().endswith("dB")]
    assert len(tones) == len(jtones) == 2
    for x, y in zip(tones, jtones):
        assert x.split(":")[0] == y.split(":")[0]
        assert abs(float(x.split(":")[1].split()[0]) - float(y.split(":")[1].split()[0])) <= 0.1


def test_analyzer_wav_agrees_with_jax(tmp_path):
    _two_tone_wav(tmp_path / "st.wav", fs=8000, seconds=1, channels=2)
    args = ["--wav", str(tmp_path / "st.wav"), "--frames", "2", "--fft-size", "512",
            "--hop", "128"]
    want = run("fftlab.cli.analyzer", args)
    got = run("fftlab_torch.cli.analyzer", args + ["--device", "cpu"])
    assert "--- frame 1 ---" in got
    assert len(got.splitlines()) == len(want.splitlines())
    for a, b in zip(got.splitlines(), want.splitlines()):
        lines_agree(a, b)


def test_bigfft_on_the_cpu():
    out = run("fftlab_torch.cli.bigfft", ["--device", "cpu"])
    snr = float(re.search(r"n=2\^18: ([\d.]+) dB", out).group(1))
    err = float(re.search(r"max err ([\d.e+-]+)", out).group(1))
    assert snr >= 120.0 and err <= 1e-4
    assert "n=2^20  -> two_pass" in out and "n=2^24  -> three_pass" in out


def _section(text, start, end):
    lines = text.splitlines()
    i = next(k for k, line in enumerate(lines) if line.startswith(start))
    j = next(k for k, line in enumerate(lines) if k > i and line.startswith(end))
    return [line for line in lines[i + 1:j] if line.strip()]


def test_features_agrees_with_jax():
    want = run("fftlab.cli.features", [])
    got = run("fftlab_torch.cli.features", ["--device", "cpu"])
    auto, jauto = (_section(t, "Auto-selection", "Plan API") for t in (got, want))
    assert len(auto) == len(jauto) == 8
    for a, b in zip(auto, jauto):
        assert a.split("max err")[0] == b.split("max err")[0]
        assert float(a.split()[-1]) < 1e-3
    for start, end in (("Butterfly diagram", "Recursion tree"),
                       ("Recursion tree", "Memory access by stage")):
        assert _section(got, start, end) == _section(want, start, end)
    mem = got.split("Memory access by stage")[1].splitlines()[1:]
    jmem = want.split("Memory access by stage")[1].splitlines()[1:]
    assert mem[:18] == jmem[:18]
    tiles = re.search(r"DIT (\d+) vs Stockham (\d+)", got).groups()
    assert tiles == re.search(r"DIT (\d+) vs Stockham (\d+)", want).groups()
    assert "the TPU's (8, 128) tile, not the H100" in got


def test_benchmark_json_as_jax(tmp_path):
    import json

    args = ["--sizes", "64,256", "--algos", "radix2_dit,stockham_mxu"]
    run("fftlab.cli.benchmark", args + ["--json", str(tmp_path / "jax.json")])
    out = run("fftlab_torch.cli.benchmark",
              args + ["--json", str(tmp_path / "port.json"), "--device", "cpu"])
    assert "best per size" in out
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(got) == set(want) | {"device_name"} and got["device_name"] == "cpu"
    assert [(r["algorithm"], r["n"]) for r in got["rows"]] == \
        [(r["algorithm"], r["n"]) for r in want["rows"]]
    assert all(r["roundtrip_ok"] for r in got["rows"])
    assert set(got["rows"][0]) == set(want["rows"][0])
    assert set(got["winners_per_size"]) == set(want["winners_per_size"])


EDGE_ARGS = {
    "serve": ["--taps", "65", "--chunk", "16384"],
    "bigfft": [],
    "features": [],
    "benchmark": ["--sizes", "64"],
}


@pytest.mark.parametrize("demo", list(EDGE_ARGS) + ["analyzer_wav"])
def test_edge_demo_without_device_needs_the_card(monkeypatch, tmp_path, demo):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if demo == "analyzer_wav":
        _two_tone_wav(tmp_path / "a.wav", seconds=1)
        demo, argv = "analyzer", ["--wav", str(tmp_path / "a.wav")]
    else:
        argv = EDGE_ARGS[demo]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(f"fftlab_torch.cli.{demo}", argv)
