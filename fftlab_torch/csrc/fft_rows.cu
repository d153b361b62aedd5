// fft_rows: batched split-plane FFT of rows of n = 2^log_n <= 16384
// points, one block per row.
//
// Replaces the TPU kernel fftlab/kernels/fft_vmem.py `_pallas_fft_impl`
// (`_fft_kernel` / `_fwd_body`: one row per program in VMEM, F_m
// contraction, twiddle, F_128 contraction, transposed store).
//
// Bound on this card: device memory. A row is read and written once,
// 16 bytes per point in split float32, against 5 n log2 n flops; at
// 16K points that is about 4.4 flops per byte, far below the H100's
// float32 balance. Design: the register engine of fft_reg.cuh. Each
// thread issues all 32 loads of its 16 points (element j + r*n/16 of
// both planes, consecutive across a warp) before its first butterfly,
// runs radix-16 passes in registers with the row's exchanges in swizzled
// shared-memory planes between them (3 at 16K), and stores its last
// pass's outputs straight to the row in natural order, with the output
// scale (the inverse's 1/n times any caller scale) folded in. A 16K row
// fills the SM's registers (1024 threads x 32 values), so one row runs
// per SM; at n <= 8192 two or more rows share one.

#include <climits>

#include "fft_reg.cuh"

using namespace fftlab;

// No pad: a row's exchanges are swizzled (fft_reg.cuh `padded`).
constexpr int kLogPadRows = 0;

template <int kLogN>
__global__ void __launch_bounds__(1 << (kLogN - 4), blocks_per_sm<(1 << (kLogN - 4))>())
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Geometry geo, float sign, float scale) {
  const size_t base = static_cast<size_t>(blockIdx.x) << kLogN;
  const float* __restrict__ ar = xr + base;
  const float* __restrict__ ai = xi + base;
  float* __restrict__ br = yr + base;
  float* __restrict__ bi = yi + base;
  const Engine<kLogN, kLogPadRows> engine{make_tile(0, geo), 0, 0, sign};
  engine.run(
      tw, scale, [&](int, int e) { return make_float2(__ldg(ar + e), __ldg(ai + e)); },
      [&](int, int e, float2 y) {
        br[e] = y.x;
        bi[e] = y.y;
      });
}

// xr, xi, yr, yi: [batch, 2^log_n] float32 on the device; tw: the
// engine's twiddle table for n; geo: the launch geometry of
// kernels/fft_vmem.py `rows_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fft_rows(const float* xr, const float* xi, float* yr, float* yi,
                               const void* tw, long long batch, int log_n, Geometry geo,
                               int direction, float scale, void* stream) {
  if (!valid_geometry(geo, log_n, 0, kLogPadRows) || batch < 1 || batch > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  return dispatch<9, 14>(log_n, [&](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    cudaError_t err = cudaFuncSetAttribute(
        fft_rows_kernel<kLogN>, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return err;
    fft_rows_kernel<kLogN><<<static_cast<unsigned>(batch), geo.threads, geo.smem,
                             static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, static_cast<const float2*>(tw), geo, static_cast<float>(direction),
        scale);
    return cudaGetLastError();
  });
}
