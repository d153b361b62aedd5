// filter_rows / os_filter: the FFT -> H -> IFFT sandwich of one row of
// n = 2^log_n <= 16384 points, whole in shared memory, one block per row.
//
// filter_rows replaces the TPU kernel fftlab/kernels/fft_vmem.py
//   `_pallas_filter_impl` (`_filter_kernel`: `_fwd_body`, times H,
//   `_inv_body`, one row per program in VMEM). The TPU kernel takes H as
//   H.reshape(128, m) to match its transposed forward output; the
//   Stockham FFT here is in natural order, so H is read in natural order.
// os_filter replaces fftlab/kernels/os_filter_vmem.py `_os_filter_impl`
//   and `_os_filter_aligned_impl` (`_os_kernel`, `_os_aligned_kernel`):
//   a causal FIR by overlap-save. Block (c, k) reads the n-point frame
//   of channel c that starts at k*hop - halo (zero below 0 and past the
//   end, so the signal needs no padded copy), runs the sandwich, and
//   writes only the hop valid samples. halo = taps - 1 exactly; the TPU
//   kernels round it up to whole 128-lane rows for their DMA layout.
//
// Bound on this card: device memory. The sandwich reads and writes each
// row once (16 bytes per point) against about 10 n log2 n flops, under
// 9 flops per byte at 16K. Design: the forward FFT, the multiply by H
// (read once from global memory, natural order, L2-resident across
// blocks) and the inverse FFT with 1/n folded into its last stage all
// run on the one shared-memory tile, so no intermediate leaves the SM.
// The overlap-save frame reads the signal n/hop times (1.008x at 129
// taps and 16K points).

#include <climits>

#include "fft_smem.cuh"

using namespace fftlab;

// Forward FFT of the tile, times H, inverse FFT with `scale` in its last
// stage. Call after a __syncthreads() that follows the tile's load;
// returns after a __syncthreads().
__device__ __forceinline__ void sandwich_smem(float2* s, const float2* __restrict__ tw_fwd,
                                              const float2* __restrict__ tw_inv,
                                              const float* __restrict__ hr,
                                              const float* __restrict__ hi, int log_n,
                                              float scale) {
  const int n = 1 << log_n;
  fft_smem(s, tw_fwd, log_n, 0, -1.0f, 1.0f);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    s[e] = cmul(s[e], make_float2(__ldg(hr + e), __ldg(hi + e)));
  }
  __syncthreads();
  fft_smem(s, tw_inv, log_n, 0, 1.0f, scale);
}

__global__ void __launch_bounds__(kMaxThreads)
filter_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv,
                   const float* __restrict__ hr, const float* __restrict__ hi, int log_n,
                   float scale) {
  float2* s = smem_tile();
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    s[e] = make_float2(xr[base + e], xi[base + e]);
  }
  __syncthreads();
  sandwich_smem(s, tw_fwd, tw_inv, hr, hi, log_n, scale);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float2 v = s[e];
    yr[base + e] = v.x;
    yi[base + e] = v.y;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
os_filter_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv,
                 const float* __restrict__ hr, const float* __restrict__ hi, long long n,
                 int hop, int halo, int n_blocks, int log_n, float scale) {
  float2* s = smem_tile();
  const int frame = 1 << log_n;
  const int k = blockIdx.x % n_blocks;
  const size_t row = static_cast<size_t>(blockIdx.x / n_blocks) * static_cast<size_t>(n);
  const long long start = static_cast<long long>(k) * hop - halo;
  for (int e = threadIdx.x; e < frame; e += blockDim.x) {
    const long long g = start + e;
    s[e] = (g >= 0 && g < n) ? make_float2(xr[row + g], xi[row + g]) : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  sandwich_smem(s, tw_fwd, tw_inv, hr, hi, log_n, scale);
  const long long out0 = static_cast<long long>(k) * hop;
  for (int e = threadIdx.x; e < hop; e += blockDim.x) {
    if (out0 + e < n) {
      const float2 v = s[halo + e];
      yr[row + out0 + e] = v.x;
      yi[row + out0 + e] = v.y;
    }
  }
}

namespace {

bool valid_row(int log_n) { return log_n >= 9 && (1 << log_n) <= kMaxTile; }

}  // namespace

// xr, xi, yr, yi: [batch, 2^log_n] float32 on the device; tw_fwd, tw_inv:
// 2^log_n float2 twiddles W_n^m of the forward and inverse transform;
// hr, hi: the n-point response in natural bin order; scale: the output
// scale (1/n for ifft(fft(x)*H)). Returns a cudaError_t.
extern "C" int fftlab_filter_rows(const float* xr, const float* xi, float* yr, float* yi,
                                  const void* tw_fwd, const void* tw_inv, const float* hr,
                                  const float* hi, long long batch, int log_n, float scale,
                                  void* stream) {
  if (!valid_row(log_n) || batch < 1 || batch > INT_MAX) return cudaErrorInvalidValue;
  const int threads = (1 << log_n) / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      filter_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  filter_rows_kernel<<<static_cast<unsigned>(batch), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, static_cast<const float2*>(tw_fwd), static_cast<const float2*>(tw_inv),
      hr, hi, log_n, scale);
  return cudaGetLastError();
}

// Overlap-save FIR. x, y: [channels, n] float32 planes on the device;
// frames of 2^log_n points start every hop samples, halo = taps - 1
// samples before the hop they produce; tw_fwd, tw_inv, hr, hi and scale as
// for fftlab_filter_rows, with hr + i*hi the spectrum of the zero-padded
// taps. Returns a cudaError_t.
extern "C" int fftlab_os_filter(const float* xr, const float* xi, float* yr, float* yi,
                                const void* tw_fwd, const void* tw_inv, const float* hr,
                                const float* hi, long long channels, long long n, int hop,
                                int halo, int log_n, float scale, void* stream) {
  if (!valid_row(log_n) || channels < 1 || n < 1 || halo < 0 || hop < 1 ||
      halo + hop > (1 << log_n)) {
    return cudaErrorInvalidValue;
  }
  const long long n_blocks = (n + hop - 1) / hop;
  if (n_blocks > INT_MAX || channels * n_blocks > INT_MAX) return cudaErrorInvalidValue;
  const int threads = (1 << log_n) / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      os_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  os_filter_kernel<<<static_cast<unsigned>(channels * n_blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, static_cast<const float2*>(tw_fwd), static_cast<const float2*>(tw_inv),
      hr, hi, n, hop, halo, static_cast<int>(n_blocks), log_n, scale);
  return cudaGetLastError();
}
