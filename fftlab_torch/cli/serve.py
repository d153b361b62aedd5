"""Serving demo: a WAV file in, a streamed FIR filter, a WAV file out.

The native WAV reader feeds the native ring buffer; the ring drains in
chunks through `FilterPlan.stream` (on the card the overlap-save kernel
`os_filter`, one launch a chunk, with exact continuity across chunks);
each filtered chunk comes back to the host once, and the native writer
stores the output as PCM16.

Usage:
  python -m fftlab_torch.cli.serve --in in.wav --out out.wav --type lowpass \
      --cutoff 2000 [--cutoff2 4000] [--taps 257] [--chunk 65536] [--device cpu]

With no --in, a two-tone test file is generated and filtered, so the
demo needs no input. It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from fftlab_torch.cli import parse
from fftlab_torch.dsp.filtering import FilterParams, FilterType
from fftlab_torch.dsp.spectrum import welch_psd_split
from fftlab_torch.native.ring import RingBuffer
from fftlab_torch.native.wav import read_wav, write_wav
from fftlab_torch.plan.filter_plan import FilterPlan
from fftlab_torch.utils.trace import span

TONES = (440.0, 6000.0)


def stream_through_ring(plan: FilterPlan, audio: np.ndarray, chunk: int,
                        timers: dict | None = None) -> np.ndarray:
    """Producer -> native ring -> `plan.stream` chunk by chunk -> host:
    the filtered float32 stream, before any clipping. With `timers`, each
    step is a `utils.trace.span` ("ring", "to_card", "stream", "to_host"),
    each waiting for the card at its end; without, the only wait per chunk
    is the copy back to the host. While the recorder is on, the steps are
    its spans too (utils/trace.py)."""
    ring = RingBuffer(max(chunk * 4, 1 << 18))
    pieces = []
    try:
        pos = 0
        while pos < len(audio) or ring.available:
            with span("ring", timers, device=plan.device):
                if pos < len(audio):
                    pos += ring.write(audio[pos : pos + chunk])
                piece = ring.read(chunk)
            if len(piece):
                with span("to_card", timers, device=plan.device):
                    x = torch.from_numpy(piece).to(plan.device)
                with span("stream", timers, device=plan.device):
                    y = plan.stream(x)
                with span("to_host", timers, device=plan.device):
                    pieces.append(y.cpu().numpy())
    finally:
        ring.close()
    return np.concatenate(pieces) if pieces else np.empty(0, np.float32)


def tone_attenuations(audio: np.ndarray, out: np.ndarray, fs: int,
                      device) -> dict:
    """{tone: dB} of the output's Welch PSD against the input's at each of
    `TONES`, over the first 2^16 samples (1024-sample segments)."""
    def psd(x):
        x = torch.from_numpy(np.ascontiguousarray(x[: 1 << 16], np.float32)).to(device)
        return welch_psd_split(x, sample_rate=fs, window_size=1024)[1].cpu().numpy()

    p_in, p_out = psd(audio), psd(out)
    att = {}
    for tone in TONES:
        k = int(tone * 1024 / fs)
        att[tone] = 10 * np.log10(max(float(p_out[k]), 1e-30) / max(float(p_in[k]), 1e-30))
    return att


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in", dest="inp", default=None)
    ap.add_argument("--out", dest="out", default=None)
    ap.add_argument("--type", default="lowpass",
                    choices=[t.value for t in FilterType if t.value != "custom"])
    ap.add_argument("--cutoff", type=float, default=2000.0)
    ap.add_argument("--cutoff2", type=float, default=0.0)
    ap.add_argument("--taps", type=int, default=257)
    ap.add_argument("--chunk", type=int, default=65536)
    return ap


def make_plan(args: argparse.Namespace, fs: int) -> FilterPlan:
    """The demo's filter: `args.taps` taps designed for the response
    `args` names at sample rate fs, on `args.device`."""
    params = FilterParams(FilterType(args.type), args.cutoff, args.cutoff2,
                          sample_rate=float(fs), transition_width=args.cutoff * 0.1)
    return FilterPlan(params, num_taps=args.taps, device=args.device)


class Served(NamedTuple):
    audio: np.ndarray  # the input as read, mixed to mono
    fs: int
    plan: FilterPlan
    filtered: np.ndarray  # the float32 stream, before clipping
    seconds: float  # wall time of the ring -> stream -> host loop


def run(args: argparse.Namespace, timers: dict | None = None) -> Served:
    """Read `args.inp`, stream it through the filter in `args.chunk`-sample
    chunks, write the clipped output to `args.out` as PCM16. With
    `timers`, the steps are `utils.trace.span`s ("wav_read", the steps of
    `stream_through_ring`, "wav_write")."""
    with span("wav_read", timers):
        audio, fs = read_wav(args.inp)
        if audio.ndim == 2:
            audio = np.ascontiguousarray(audio.mean(axis=1), np.float32)
    plan = make_plan(args, fs)
    t0 = time.perf_counter()
    filtered = stream_through_ring(plan, audio, args.chunk, timers)
    seconds = time.perf_counter() - t0
    with span("wav_write", timers):
        write_wav(args.out, np.clip(filtered, -1, 1), fs)
    return Served(audio, fs, plan, filtered, seconds)


def main() -> None:
    args = parse(build_parser())
    if args.inp is None:
        # 440 Hz + 6 kHz at 16 kHz, 4 s
        fs = 16000
        t = np.arange(fs * 4) / fs
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)
               + 0.4 * np.sin(2 * np.pi * 6000 * t)).astype(np.float32)
        fd, args.inp = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        write_wav(args.inp, sig, fs)
        print(f"generated test input {args.inp} "
              f"(440 Hz + 6 kHz, {len(sig)/fs:.1f}s @ {fs} Hz)")
    if args.out is None:
        fd, args.out = tempfile.mkstemp(suffix=".filtered.wav")
        os.close(fd)

    r = run(args)
    print(f"{r.plan.describe()}  fs={r.fs}  {args.type} @ {args.cutoff:g} Hz")
    rate = len(r.audio) / r.seconds / 1e6
    print(f"filtered {len(r.audio)} samples in {r.seconds*1e3:.1f} ms "
          f"({rate:.1f} Msamples/s, {rate*1e6/r.fs:.0f}x realtime)")
    print(f"wrote {args.out}")

    for tone, att in tone_attenuations(r.audio, r.filtered, r.fs, args.device).items():
        print(f"  {tone:6.0f} Hz: {att:+7.1f} dB")


if __name__ == "__main__":
    main()
