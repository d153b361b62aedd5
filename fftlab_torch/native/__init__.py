"""The native (C++) runtime on the host, through ctypes (counterpart of
fftlab/native): the repo's `native/` sources, built by `lib` with g++
into `fftlab_torch/_build/native/` at first use.

- ``wav``   WAV file IO (PCM 8/16/24/32 and float32 in, PCM16 out)
- ``ring``  the lock-free single-producer/single-consumer float32 ring
            buffer, the streaming front-end of `cli/serve`
- ``q15``   the Q15 block-floating-point FFT, the reduced-precision oracle
- ``fft64`` the float64 host FFT, power-of-two sizes

The wrappers take and return numpy arrays, as the JAX package's do; a
tensor is read through `.cpu().numpy()`. A missing compiler raises
RuntimeError.
"""

from fftlab_torch.native.lib import load_native_lib, native_available
