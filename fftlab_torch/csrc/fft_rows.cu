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
// float32 balance. Design: the whole row sits in shared memory (128 KB
// at 16K, opted in above 48 KB), the loads and stores are coalesced and
// in natural order, the radix-4 stages run in registers with the
// twiddles from a float64-built table, and the output scale (the
// inverse's 1/n times any caller scale) rides the last stage, so the
// transform costs exactly one read and one write of the row.

#include <climits>

#include "fft_smem.cuh"

using namespace fftlab;

__global__ void __launch_bounds__(kMaxThreads)
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, int log_n, float sign, float scale) {
  float2* s = smem_tile();
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    s[e] = make_float2(xr[base + e], xi[base + e]);
  }
  __syncthreads();
  fft_smem(s, tw, log_n, 0, sign, scale);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float2 v = s[e];
    yr[base + e] = v.x;
    yi[base + e] = v.y;
  }
}

// xr, xi, yr, yi: [batch, 2^log_n] float32 on the device; tw: 2^log_n
// float2 twiddles W_n^m for this direction. Returns a cudaError_t.
extern "C" int fftlab_fft_rows(const float* xr, const float* xi, float* yr, float* yi,
                               const void* tw, long long batch, int log_n, int direction,
                               float scale, void* stream) {
  const int threads = (1 << log_n) / kPerThread;
  if (log_n < 9 || (1 << log_n) > kMaxTile || batch < 1 || batch > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(sizeof(float2)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      fft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fft_rows_kernel<<<static_cast<unsigned>(batch), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, static_cast<const float2*>(tw), log_n,
      static_cast<float>(direction), scale);
  return cudaGetLastError();
}
