"""Signal file IO (counterpart of fftlab/utils/io.py): the reference's
text format (a '#' header, then `index real imag magnitude phase` per
sample), npz, and a gnuplot script for a saved signal. Files are byte for
byte the JAX package's for the same array; a tensor is read on the
host."""

from __future__ import annotations

import numpy as np

from fftlab_torch.core.types import to_host


def save_complex_signal(path: str, x, comment: str = "") -> None:
    """The text format: header lines starting with '#', then
    `index real imag magnitude phase` per sample."""
    x = to_host(x)
    if x.ndim != 1:
        raise ValueError(f"save_complex_signal expects 1D, got {x.shape}")
    x = x.astype(np.complex128)
    with open(path, "w") as f:
        f.write(f"# fftlab complex signal, n={len(x)}\n")
        if comment:
            f.write(f"# {comment}\n")
        f.write("# index real imag magnitude phase\n")
        for i, v in enumerate(x):
            f.write(
                f"{i} {v.real:.17g} {v.imag:.17g} "
                f"{abs(v):.17g} {np.angle(v):.17g}\n"
            )


def load_complex_signal(path: str) -> np.ndarray:
    """Load the text format (the C reference's output has the same
    columns) as complex128."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                raise ValueError(f"malformed signal row: {line!r}")
            rows.append(complex(float(parts[1]), float(parts[2])))
    return np.asarray(rows, dtype=np.complex128)


def save_signal_npz(path: str, **arrays) -> None:
    """Binary save of named arrays (numpy or tensors)."""
    np.savez_compressed(path, **{k: to_host(v) for k, v in arrays.items()})


def load_signal_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def export_gnuplot_script(path: str, data_path: str,
                          title: str = "Spectrum",
                          xlabel: str = "Frequency bin",
                          ylabel: str = "Magnitude") -> None:
    """A gnuplot script that plots a saved signal's magnitude column."""
    with open(path, "w") as f:
        f.write(
            f'set title "{title}"\n'
            f'set xlabel "{xlabel}"\n'
            f'set ylabel "{ylabel}"\n'
            "set grid\n"
            f'plot "{data_path}" using 1:4 with lines title "magnitude"\n'
        )
