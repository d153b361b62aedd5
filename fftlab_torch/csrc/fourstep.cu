// fourstep_pass1 / fourstep_pass2: the two-pass four-step FFT for
// power-of-two n = L1*L2 in 2^15..2^21 (L1 <= L2, L1 <= 1024).
//
// Replaces two TPU kernels that compute one transform:
//   fftlab/kernels/resident_vmem.py `_fft_resident_v6_impl` (one VMEM
//     residency holds the whole 8 MB signal; no Hopper block can, its
//     shared memory ends at 227 KB), and
//   fftlab/kernels/fourstep_vmem.py `_two_pass` (`_pass1_kernel`,
//     `_pass2_kernel`), whose two passes these kernels follow.
//
// Pass 1: one block per (batch row b, tile of W consecutive columns j2).
//   It loads x[b, j1, c*W .. c*W+W) for every j1 (W floats = 64 bytes
//   contiguous per j1 at W = 16), runs the length-L1 FFT down each
//   column in shared memory, multiplies by W_n^{k1*j2} in the rank-1 form
//   A[c, k1] * P[k1, j2 - c*W] (fourstep_vmem._rank1_twiddle_np, float64-
//   built tables), and writes the row-major (B, L1, L2) intermediate.
// Pass 2: one block per (b, tile of R consecutive rows k1). It loads R
//   whole rows, runs the length-L2 FFT along each with the output scale
//   folded into the last stage, and stores element (k2, k1) at
//   k2*L1 + k1: the natural-order spectrum, with the corner turn done by
//   the store (runs of R consecutive k1).
//
// Bound on this card: device memory. Each pass reads and writes the
// signal once (32 bytes per point in all, 64 MB per pass at 16 x 2^20),
// against about 5 n log2 n flops. Design: every FFT stage stays in
// shared memory and registers, the twiddles are fused into pass 1's
// store, the scale into pass 2's last stage, and the transpose into
// pass 2's store, so no other pass over device memory exists. At 2^20
// the intermediate of a few rows fits the 50 MB L2; keeping it there on
// purpose (and a blocked intermediate layout) is later work.

#include <climits>

#include "fft_smem.cuh"

using namespace fftlab;

__global__ void __launch_bounds__(kMaxThreads)
fourstep_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ mr, float* __restrict__ mi,
                      const float2* __restrict__ tw1, const float2* __restrict__ a_tab,
                      const float2* __restrict__ p_tab, int log_l1, int log_l2, int log_w,
                      float sign) {
  float2* s = smem_tile();
  const int log_c = log_l2 - log_w;
  const int c = blockIdx.x & ((1 << log_c) - 1);
  const size_t b = blockIdx.x >> log_c;
  const int w_mask = (1 << log_w) - 1;
  const int tile = 1 << (log_l1 + log_w);
  const size_t col0 = (b << (log_l1 + log_l2)) + (static_cast<size_t>(c) << log_w);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const size_t g = col0 + (static_cast<size_t>(e >> log_w) << log_l2) + (e & w_mask);
    s[e] = make_float2(xr[g], xi[g]);
  }
  __syncthreads();
  fft_smem(s, tw1, log_l1, log_w, sign, 1.0f);
  const float2* a_c = a_tab + (static_cast<size_t>(c) << log_l1);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int k1 = e >> log_w;
    const float2 w = cmul(__ldg(a_c + k1), __ldg(p_tab + e));  // p_tab is (L1, W)
    const float2 y = cmul(s[e], w);
    const size_t g = col0 + (static_cast<size_t>(k1) << log_l2) + (e & w_mask);
    mr[g] = y.x;
    mi[g] = y.y;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fourstep_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                      float* __restrict__ yr, float* __restrict__ yi,
                      const float2* __restrict__ tw2, int log_l1, int log_l2, int log_r,
                      float sign, float scale) {
  float2* s = smem_tile();
  const int log_g = log_l1 - log_r;
  const int k1_0 = (blockIdx.x & ((1 << log_g) - 1)) << log_r;
  const size_t b = blockIdx.x >> log_g;
  const int l2_mask = (1 << log_l2) - 1;
  const int r_mask = (1 << log_r) - 1;
  const int tile = 1 << (log_l2 + log_r);
  const size_t base = b << (log_l1 + log_l2);
  const size_t row0 = base + (static_cast<size_t>(k1_0) << log_l2);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    // e = r*L2 + j2: R whole rows, read contiguously
    s[((e & l2_mask) << log_r) + (e >> log_l2)] = make_float2(mr[row0 + e], mi[row0 + e]);
  }
  __syncthreads();
  fft_smem(s, tw2, log_l2, log_r, sign, scale);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    // e = k2*R + r  ->  natural index k2*L1 + k1_0 + r
    const size_t o = base + (static_cast<size_t>(e >> log_r) << log_l1) + k1_0 + (e & r_mask);
    const float2 v = s[e];
    yr[o] = v.x;
    yi[o] = v.y;
  }
}

namespace {

bool valid_tile(int log_l, int log_t) {
  const int tile = 1 << (log_l + log_t);
  return log_l >= 1 && tile <= kMaxTile && tile / kPerThread >= 32;
}

}  // namespace

// Pass 1. x: [batch, L1*L2] float32 planes; m: the (batch, L1, L2)
// intermediate planes; tw1: L1 float2 twiddles W_L1^m; a_tab: (L2/W, L1)
// and p_tab: (L1, W) float2 rank-1 twiddle factors. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1(const float* xr, const float* xi, float* mr, float* mi,
                                     const void* tw1, const void* a_tab, const void* p_tab,
                                     long long batch, int log_l1, int log_l2, int log_w,
                                     int direction, void* stream) {
  const long long blocks = batch << (log_l2 - log_w);
  if (!valid_tile(log_l1, log_w) || log_w > log_l2 || batch < 1 || blocks > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const int threads = (1 << (log_l1 + log_w)) / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) << (log_l1 + log_w);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_pass1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fourstep_pass1_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xr, xi, mr, mi, static_cast<const float2*>(tw1), static_cast<const float2*>(a_tab),
      static_cast<const float2*>(p_tab), log_l1, log_l2, log_w, static_cast<float>(direction));
  return cudaGetLastError();
}

// Pass 2. m: the (batch, L1, L2) intermediate planes; y: [batch, L1*L2]
// natural-order output planes; tw2: L2 float2 twiddles W_L2^m; R = 2^log_r
// rows per block. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2(const float* mr, const float* mi, float* yr, float* yi,
                                     const void* tw2, long long batch, int log_l1, int log_l2,
                                     int log_r, int direction, float scale, void* stream) {
  const long long blocks = batch << (log_l1 - log_r);
  if (!valid_tile(log_l2, log_r) || log_r > log_l1 || batch < 1 || blocks > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const int threads = (1 << (log_l2 + log_r)) / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) << (log_l2 + log_r);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_pass2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fourstep_pass2_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      mr, mi, yr, yi, static_cast<const float2*>(tw2), log_l1, log_l2, log_r,
      static_cast<float>(direction), scale);
  return cudaGetLastError();
}

// Message for a cudaError_t returned by the functions above.
extern "C" const char* fftlab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
