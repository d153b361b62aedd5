// Shared device code: a length-L FFT in shared memory over a tile of
// independent transforms, radix-4 Stockham autosort (one radix-2 stage
// first when log2 L is odd), natural order in and out, no bit reversal.
//
// Layout: T = 2^log_t transforms of length L = 2^log_l, element e of
// transform t at s[e*T + t]. Consecutive threads take consecutive t, so
// the column tiles of the four-step passes (T = 16 or 8) and single rows
// (T = 1) share one code path.
//
// The tile lives in ONE buffer of T*L complex values. A stage reads all
// its inputs into registers, synchronises, then writes all its outputs,
// so no ping-pong buffer is needed: a 16K-point tile takes 128 KB of the
// block's 227 KB instead of 256 KB. Each thread therefore holds
// kPerThread complex values across a stage, and a tile of T*L values
// runs on exactly T*L / kPerThread threads (at most 1024).
//
// Twiddles come from a float32 table tw[m] = exp(2*pi*i*direction*m/L),
// built on the host in float64; nothing trigonometric runs on the device.

#pragma once

#include <cuda_runtime.h>

namespace fftlab {

constexpr int kPerThread = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTile = kPerThread * kMaxThreads;  // 16384 complex, 128 KB

__device__ __forceinline__ float2* smem_tile() {
  extern __shared__ __align__(16) float2 fftlab_smem[];
  return fftlab_smem;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * (sign * i): the radix-4 rotation, sign = direction.
__device__ __forceinline__ float2 rot(float2 a, float sign) {
  return make_float2(-sign * a.y, sign * a.x);
}

__device__ __forceinline__ void butterfly(float2 (&a)[2], float) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

__device__ __forceinline__ void butterfly(float2 (&a)[4], float sign) {
  const float2 t0 = cadd(a[0], a[2]);
  const float2 t1 = csub(a[0], a[2]);
  const float2 t2 = cadd(a[1], a[3]);
  const float2 t3 = rot(csub(a[1], a[3]), sign);
  a[0] = cadd(t0, t2);
  a[1] = cadd(t1, t3);
  a[2] = csub(t0, t2);
  a[3] = csub(t1, t3);
}

// One radix-R stage with current sub-transform length ns = 2^log_ns:
// butterfly j of transform t reads elements j + r*L/R, multiplies input r
// by W_{ns*R}^{r*(j mod ns)}, and writes output r to
// (j / ns)*ns*R + (j mod ns) + r*ns. Outputs are multiplied by `scale`.
template <int R>
__device__ __forceinline__ void stockham_stage(float2* s, const float2* __restrict__ tw,
                                               int log_l, int log_t, int log_ns,
                                               float sign, float scale) {
  constexpr int kLogR = R == 4 ? 2 : 1;
  constexpr int kButterflies = kPerThread / R;
  const int t_mask = (1 << log_t) - 1;
  const int ns_mask = (1 << log_ns) - 1;
  const int span = 1 << (log_l - kLogR + log_t);  // distance between a butterfly's inputs
  const int tw_shift = log_l - log_ns - kLogR;    // W_{ns*R}^x = tw[x << tw_shift]
  float2 v[kPerThread];
#pragma unroll
  for (int b = 0; b < kButterflies; ++b) {
    const int q = threadIdx.x + b * blockDim.x;
    const int t = q & t_mask;
    const int j = q >> log_t;
    const int k = j & ns_mask;
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = s[(j << log_t) + t + r * span];
#pragma unroll
    for (int r = 1; r < R; ++r) a[r] = cmul(a[r], __ldg(tw + ((r * k) << tw_shift)));
    butterfly(a, sign);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = a[r];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kButterflies; ++b) {
    const int q = threadIdx.x + b * blockDim.x;
    const int t = q & t_mask;
    const int j = q >> log_t;
    const int base = ((j >> log_ns) << (log_ns + kLogR)) + (j & ns_mask);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 y = v[b * R + r];
      s[((base + (r << log_ns)) << log_t) + t] = make_float2(y.x * scale, y.y * scale);
    }
  }
  __syncthreads();
}

// The whole length-L transform of every column of the tile, the last
// stage's outputs times `scale`. Call after a __syncthreads() that follows
// the tile's load; returns after a __syncthreads(), so any thread may then
// read any element.
__device__ __forceinline__ void fft_smem(float2* s, const float2* __restrict__ tw,
                                         int log_l, int log_t, float sign, float scale) {
  int log_ns = 0;
  if (log_l & 1) {
    stockham_stage<2>(s, tw, log_l, log_t, 0, sign, log_l == 1 ? scale : 1.0f);
    log_ns = 1;
  }
  for (; log_ns < log_l; log_ns += 2) {
    stockham_stage<4>(s, tw, log_l, log_t, log_ns, sign,
                      log_ns + 2 == log_l ? scale : 1.0f);
  }
}

}  // namespace fftlab
