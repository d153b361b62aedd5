"""Plain reference of the spectral-filter sandwich ifft(fft(x) * H), 1/n
scaled, on split planes: torch.fft in complex128 on the float32 inputs
and the float32 response that the program is handed, H in natural bin
order. The response is the benchmark's: complex, re and im normal with
variance 1/2 (E|H|^2 = 1), drawn from the seed. The control is the same
sandwich with both transforms in TF32 (`tf32.dft_tf32`)."""

from __future__ import annotations

import torch

from cellbench.reference.tf32 import dft_tf32


def make_constants(config: dict, gen: torch.Generator, device) -> dict:
    h = torch.randn((2, int(config["n"])), generator=gen, device=device) * 0.5 ** 0.5
    return {"hr": h[0], "hi": h[1]}


def _forward_only(direction: str) -> None:
    if direction != "forward":
        raise ValueError(f"the sandwich runs forward then inverse; got direction {direction!r}")


def reference(xr, xi, consts: dict, config: dict, direction: str) -> torch.Tensor:
    """complex128 [rows, n]."""
    _forward_only(direction)
    x = torch.complex(xr.double(), xi.double())
    h = torch.complex(consts["hr"].double(), consts["hi"].double())
    return torch.fft.ifft(torch.fft.fft(x) * h)


def control(xr, xi, consts: dict, config: dict, direction: str):
    """float32 planes [rows, n] of the same sandwich in TF32."""
    _forward_only(direction)
    sr, si = dft_tf32(xr, xi)
    hr, hi = consts["hr"], consts["hi"]
    return dft_tf32(sr * hr - si * hi, sr * hi + si * hr, inverse=True)
