"""FFT filtering demo: a multi-tone signal through low-, high- and
band-pass filters with transition bands, with the spectra before and
after and each response's gains."""

from __future__ import annotations

import argparse

import numpy as np

from fftlab_torch.algos.real_fft import rfft, rfftfreq
from fftlab_torch.cli import parse
from fftlab_torch.core.types import as_tensor, to_host
from fftlab_torch.dsp.filtering import FilterParams, FilterType, design_response, fft_filter
from fftlab_torch.utils.plotting import ascii_spectrum
from fftlab_torch.utils.signals import generate_multi_tone


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--fs", type=float, default=8000.0)
    args = parse(ap)

    n, fs = args.n, args.fs
    x = as_tensor(generate_multi_tone(n, [200.0, 1200.0, 3000.0], None, fs), args.device)
    freqs = rfftfreq(n, 1.0 / fs)

    print("input spectrum:")
    print(ascii_spectrum(to_host(rfft(x).abs()), 16, 40, freqs))

    for ft, cut in [(FilterType.LOWPASS, (600.0, 0.0)),
                    (FilterType.HIGHPASS, (2000.0, 0.0)),
                    (FilterType.BANDPASS, (800.0, 2000.0))]:
        params = FilterParams(filter_type=ft, cutoff_low=cut[0],
                              cutoff_high=cut[1], sample_rate=fs,
                              transition_width=100.0)
        y = fft_filter(x, params)
        print(f"\n{ft.value} ({cut[0]:.0f}"
              + (f"-{cut[1]:.0f}" if cut[1] else "") + " Hz) output:")
        print(ascii_spectrum(to_host(rfft(y).abs()), 16, 40, freqs))
        H = design_response(n, params)
        print(f"  response H: passband gain {np.max(np.abs(H)):.2f}, "
              f"stopband {np.min(np.abs(H)):.2e}")


if __name__ == "__main__":
    main()
