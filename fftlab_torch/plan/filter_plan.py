"""FilterPlan: plan-once causal FIR filtering, the serving API
(counterpart of fftlab/plan/filter_plan.py:30-255).

Build the plan once (taps, block size, device), then

- ``plan(x)``            filter whole signals [..., n] (batched),
- ``plan(a, b)``         filter two real channels as the two planes of
                         one complex signal (a real H filters each plane
                         on its own),
- ``plan.stream(chunk)`` filter an unbounded 1-D stream chunk by chunk;
                         the carried (nh-1)-sample tail makes
                         concat(stream(c) for c) equal plan(concat(c)).

- a plan with a mesh (`mesh=`, a `dist` DeviceMesh) runs the sharded
  overlap-save (`dist/overlap_save_split.filter_sharded`): every rank
  passes the whole signal, filters its block of the `time_axis` after
  its left neighbour's halo, and gets its block of the output back.

Routing, by the taps alone: when the halo fits the overlap-save kernel's
frame (`os_filter_vmem.taps_fit`, the JAX package's rule), the
overlap-save route runs: the `os_filter` kernel on a CUDA plan, its plain
version on a CPU plan. Longer taps take the tensor-op block path
(`_filter_blocks`). A sharded plan takes the same route on each block.

A plan runs on the card unless it is built with `device="cpu"` (a
sharded plan: on its mesh's device); without a CUDA device the default
raises rather than falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fftlab_torch.algos.split_stockham import (
    _twiddle_split,
    stockham_fft_split_unscaled,
)
from fftlab_torch.core.framing import frame_signal_strided
from fftlab_torch.core.types import FORWARD, INVERSE, next_power_of_two
from fftlab_torch.dsp.filtering import FilterParams, design_fir
from fftlab_torch.kernels.fft_vmem import supported_size
from fftlab_torch.kernels.os_filter_vmem import (
    MAX_FFT_SIZE,
    os_response_np,
    run_os_filter,
    taps_fit,
)


class FilterPlan:
    """A frozen FIR filtering plan on one device.

    h: real taps [nh], or a FilterParams, designed into `num_taps` taps by
    `dsp.filtering.design_fir`. fft_size: the block of the tensor-op path
    (default max(next_pow2(4*nh), 256)); the overlap-save kernel runs at
    the nearest frame size it takes (`kernel_fft_size`). Results are
    float32 tensors on `device`: the card by default, the CPU only when
    asked for with `device="cpu"`. `mesh`: a `dist` DeviceMesh whose
    `time_axis` a sharded plan splits time over; the plan then runs on
    the mesh's device and `device` is not read.
    """

    def __init__(self, h, fft_size: int | None = None, mesh=None,
                 time_axis: str = "sp", num_taps: int = 129, device="cuda"):
        if isinstance(h, FilterParams):
            h = design_fir(num_taps, h)
        self.h = np.asarray(h, dtype=np.float32)
        if self.h.ndim != 1:
            raise ValueError(f"taps must be 1D, got {self.h.shape}")
        self.nh = int(self.h.shape[-1])
        if fft_size is None:
            fft_size = max(next_power_of_two(4 * self.nh), 256)
        if fft_size < next_power_of_two(2 * self.nh):
            raise ValueError(f"fft_size {fft_size} too small for {self.nh} taps")
        self.fft_size = int(fft_size)
        self.mesh = mesh
        self.time_axis = time_axis
        if mesh is not None:
            from fftlab_torch.dist.mesh import mesh_device

            device = mesh_device(mesh)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FilterPlan runs on the card by default and no CUDA device is "
                'available; pass device="cpu" to run the plan on the CPU')
        self._tail: torch.Tensor | None = None

        # each route reads its own response: the overlap-save route the FFT
        # of the float64 taps at its frame, the block path the float32 FFT
        # of the padded taps, as the JAX plan builds it
        if self.uses_kernel():
            kr, ki = os_response_np(self.h, self.kernel_fft_size())
            self._Kr = torch.from_numpy(kr).to(self.device)
            self._Ki = torch.from_numpy(ki).to(self.device)
        else:
            hp = torch.from_numpy(np.pad(self.h, (0, self.fft_size - self.nh))).to(
                self.device)
            self._Hr, self._Hi = stockham_fft_split_unscaled(
                hp, torch.zeros_like(hp), FORWARD)

    @classmethod
    def from_jax(cls, h, fft_size: int, tail=None, device="cuda") -> "FilterPlan":
        """A plan that continues a JAX FilterPlan's stream: its taps
        (`plan.h`), `plan.fft_size` and the carried tail (`plan._tail`,
        None before the first chunk), all as numpy."""
        plan = cls(h, fft_size=fft_size, device=device)
        if tail is not None:
            t = np.asarray(tail, dtype=np.float32)
            if t.shape != (plan.nh - 1,):
                raise ValueError(f"tail has shape {t.shape}, want ({plan.nh - 1},)")
            plan._tail = torch.from_numpy(t.copy()).to(plan.device)
        return plan

    # -- routes -----------------------------------------------------------

    def kernel_fft_size(self) -> int:
        """The overlap-save frame: fft_size if the row sandwich takes it,
        else the next size it takes, at most 16384."""
        if supported_size(self.fft_size):
            return self.fft_size
        c = max(next_power_of_two(self.fft_size), 1024)
        while not supported_size(c) and c < MAX_FFT_SIZE:
            c *= 2
        return min(c, MAX_FFT_SIZE)

    def uses_kernel(self) -> bool:
        """True when the overlap-save route serves this plan."""
        return taps_fit(self.nh, self.kernel_fft_size())

    def _filter_blocks(self, xr: torch.Tensor, xi: torch.Tensor):
        """Overlap-save in tensor ops on a halo-prefixed signal pair ->
        the valid outputs."""
        nh, fft_size = self.nh, self.fft_size
        hop = fft_size - (nh - 1)
        valid = int(xr.shape[-1]) - (nh - 1)
        n_blocks = -(-valid // hop)
        Fr, Fi = stockham_fft_split_unscaled(
            frame_signal_strided(xr, fft_size, hop, n_blocks),
            frame_signal_strided(xi, fft_size, hop, n_blocks), FORWARD)
        Gr, Gi = _twiddle_split(Fr, Fi, self._Hr, self._Hi)
        yr, yi = stockham_fft_split_unscaled(Gr, Gi, INVERSE)
        s = 1.0 / fft_size
        shape = (*yr.shape[:-2], n_blocks * hop)
        yr = (yr * s)[..., nh - 1:].reshape(shape)[..., :valid]
        yi = (yi * s)[..., nh - 1:].reshape(shape)[..., :valid]
        return yr, yi

    def causal(self, xr: torch.Tensor, xi: torch.Tensor):
        """The zero-history causal filter of [..., n] planes on the plan's
        device, by route (no mesh)."""
        if self.uses_kernel():
            return run_os_filter(xr, xi, self._Kr, self._Ki, self.nh)
        pad = (self.nh - 1, 0)
        return self._filter_blocks(F.pad(xr, pad), F.pad(xi, pad))

    def _plane(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    # -- whole signals ----------------------------------------------------

    def __call__(self, x, x_imag=None):
        """Filter [..., n]: the causal output, same length. With `x_imag`,
        a second real channel (or the imaginary plane) is filtered too and
        (yr, yi) comes back. A sharded plan takes the whole signal on every
        rank and returns this rank's block [..., n/p] of the output."""
        xr = self._plane(x)
        if self.mesh is not None:
            from fftlab_torch.dist.overlap_save_split import filter_sharded

            xi = self._plane(x_imag) if x_imag is not None else torch.zeros_like(xr)
            yr, yi = filter_sharded(self, xr, xi, self.mesh, self.time_axis)
            return (yr, yi) if x_imag is not None else yr
        if x_imag is None and xr.ndim == 1:
            packed = self._call_packed_real(xr)
            if packed is not None:
                return packed
        xi = self._plane(x_imag) if x_imag is not None else torch.zeros_like(xr)
        yr, yi = self.causal(xr, xi)
        return (yr, yi) if x_imag is not None else yr

    def _call_packed_real(self, xr: torch.Tensor):
        """One long real channel as the two halves of one complex signal:
        every transform then carries two half-signals, half the work, exact
        by linearity (conv(a + i*b, h) = conv(a, h) + i*conv(b, h) for real
        h). The imaginary plane starts with the first half's (nh-1)-sample
        tail, so its causal history is exact. None when the signal is too
        short to split."""
        n = int(xr.shape[-1])
        s = -(-n // 2)
        keep = self.nh - 1
        if s < max(2 * self.fft_size, keep + 1):
            return None
        a, b = xr[:s], xr[s:]
        T = s + keep
        ar = F.pad(a, (0, T - s))
        ai = F.pad(torch.cat([a[s - keep:], b]), (0, T - keep - (n - s)))
        yr, yi = self.causal(ar, ai)
        return torch.cat([yr[:s], yi[keep:keep + (n - s)]])

    # -- streaming --------------------------------------------------------

    def stream(self, chunk) -> torch.Tensor:
        """Filter the next chunk of an unbounded 1-D real stream. The
        (nh-1)-sample tail carried between calls makes
        concat(stream(c) for c) == plan(concat(c))."""
        c = self._plane(chunk)
        if c.ndim != 1:
            raise ValueError("stream() expects 1D chunks")
        keep = self.nh - 1
        if self._tail is None:
            self._tail = torch.zeros(keep, dtype=torch.float32, device=self.device)
        if c.numel() == 0:
            return c
        buf = torch.cat([self._tail, c])
        self._tail = buf[len(buf) - keep:].clone()
        # output i >= keep reads buf[i-keep..i] only, so the zero history
        # before buf never reaches what is returned
        yr, _ = self.causal(buf, torch.zeros_like(buf))
        return yr[keep:]

    def reset(self) -> None:
        """Forget the streaming state (start a new stream)."""
        self._tail = None

    def describe(self) -> str:
        route = (f"os_filter[{self.kernel_fft_size()}]" if self.uses_kernel()
                 else "blocks")
        if self.mesh is not None:
            route += f", mesh[{self.time_axis}]={self.mesh[self.time_axis].size()}"
        return (f"FilterPlan(nh={self.nh}, fft_size={self.fft_size}, "
                f"hop={self.fft_size - self.nh + 1}, {route}, {self.device})")
