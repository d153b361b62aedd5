"""The SPSC ring buffer (native/ringbuffer.cpp through ctypes; counterpart
of fftlab/native/ring.py): the streaming front-end of `cli/serve`."""

from __future__ import annotations

import ctypes

import numpy as np

from fftlab_torch.core.types import to_host
from fftlab_torch.native.lib import load_native_lib


class RingBuffer:
    """Lock-free single-producer/single-consumer float32 ring buffer; the
    capacity rounds up to a power of two.

    The STFT consumption pattern is `frame = peek_hop(fft_size, hop)`:
    copy fft_size samples, consume only hop, so frames overlap by
    fft_size - hop. `close` frees the buffer; any use after it raises
    ValueError.
    """

    def __init__(self, capacity: int):
        self._lib = load_native_lib()
        self._h = self._lib.fftlab_ring_create(int(capacity))
        if not self._h:
            raise MemoryError(f"ring_create({capacity}) failed")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fftlab_ring_destroy(self._h)
            self._h = None

    __del__ = close

    def _handle(self):
        """The live handle; raises rather than hand the C side a NULL."""
        h = self._h
        if not h:
            raise ValueError("RingBuffer is closed")
        return h

    @property
    def capacity(self) -> int:
        return self._lib.fftlab_ring_capacity(self._handle())

    @property
    def available(self) -> int:
        return self._lib.fftlab_ring_available(self._handle())

    @property
    def space(self) -> int:
        return self._lib.fftlab_ring_space(self._handle())

    def write(self, samples) -> int:
        """Producer side (numpy or a tensor); returns how many samples were
        accepted."""
        a = np.ascontiguousarray(to_host(samples), dtype=np.float32)
        return self._lib.fftlab_ring_write(
            self._handle(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.size)

    def read(self, n: int) -> np.ndarray:
        """Consumer side; returns up to n samples (consumed)."""
        out = np.empty(int(n), dtype=np.float32)
        got = self._lib.fftlab_ring_read(
            self._handle(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
        return out[:got]

    def peek_hop(self, frame_size: int, hop: int) -> np.ndarray | None:
        """Copy frame_size samples, consume hop (overlapping STFT frames).
        Returns None until frame_size samples are buffered."""
        out = np.empty(int(frame_size), dtype=np.float32)
        got = self._lib.fftlab_ring_peek_hop(
            self._handle(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(frame_size), int(hop))
        return out if got else None
