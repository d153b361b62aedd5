// fused_stage: one radix-r Cooley-Tukey stage over the leading digit of
// [B, r*M] split planes, times the stage twiddle W_n^{k*m} (n = r*M) or
// with no twiddle:
//   out[b, k*M + m] = W_n^{k*m} * sum_j W_r^{k*j} * x[b, j*M + m].
//
// Replaces fftlab/kernels/stage_fused.py `fused_stage` (pallas_call at
// :96, `_stage_kernel`), the stage of the JAX package's `pallas_pipeline`
// route, whose leaf matmul and digit reversal stay outside any kernel in
// both packages (kernels/stage_fused.py `fft_split_pipeline`).
//
// Design: one block per (G consecutive batch rows, tile of T consecutive
// columns m). It loads x[b, j, m0 .. m0+T) for every j < r and every row
// of the block, T floats contiguous per (row, j); runs the length-r FFT
// down each of the G*T columns in shared memory (fft_smem.cuh, the G*T
// columns as its side-by-side transforms); multiplies W_n^{k*m} in the
// rank-1 form A[c, k] * P[k, l], m = c*T + l (fourstep_vmem.
// _rank1_twiddle_np, float64-built tables of (M/T)*r + r*T values); and
// writes out[b, k, m0 .. m0+T). The tile is r*G*T = 4096 values (32 KB)
// wherever the shape allows: T = 4096/r clamped to [32, M], and G rows
// fill the rest, so a stage whose whole row is shorter than fft_smem's
// smallest tile of 512 values (r = 2 at M = 128) takes several rows per
// block; rows past the batch load zeros and store nothing.
//
// Bound on this card: device memory. The stage reads and writes the
// signal once, 16 bytes per point, against 5 n log2 r flops. The TPU
// kernel streams the whole (r, M) twiddle table beside the signal (its
// cost estimate counts 24 bytes per point); the rank-1 tables here hold
// M/T*r + r*T values, so no n-sized table is read and the stage moves
// the 16 bytes per point it needs.

#include <climits>

#include "fft_smem.cuh"

using namespace fftlab;

template <bool kTwiddle>
__global__ void __launch_bounds__(kMaxThreads)
fused_stage_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float2* __restrict__ tw, const float2* __restrict__ a_tab,
                   const float2* __restrict__ p_tab, long long rows, int log_r, int log_m,
                   int log_t, int log_g, float sign) {
  float2* s = smem_tile();
  const int log_c = log_m - log_t;
  const int c = blockIdx.x & ((1 << log_c) - 1);
  const long long b0 = static_cast<long long>(blockIdx.x >> log_c) << log_g;
  const int log_gt = log_g + log_t;
  const int gt_mask = (1 << log_gt) - 1;
  const int t_mask = (1 << log_t) - 1;
  const int tile = 1 << (log_r + log_gt);
  const size_t m0 = static_cast<size_t>(c) << log_t;
  // element e = j*(G*T) + g*T + l holds x[b0 + g, j*M + m0 + l]
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long b = b0 + ((e & gt_mask) >> log_t);
    float2 v = make_float2(0.0f, 0.0f);
    if (b < rows) {
      const size_t g = (static_cast<size_t>(b) << (log_r + log_m)) +
                       (static_cast<size_t>(e >> log_gt) << log_m) + m0 + (e & t_mask);
      v = make_float2(xr[g], xi[g]);
    }
    s[e] = v;
  }
  __syncthreads();
  fft_smem(s, tw, log_r, log_gt, sign, 1.0f);
  const float2* a_c = a_tab + (static_cast<size_t>(c) << log_r);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long b = b0 + ((e & gt_mask) >> log_t);
    if (b >= rows) continue;
    const int k = e >> log_gt;
    const int l = e & t_mask;
    float2 y = s[e];
    if constexpr (kTwiddle) {
      y = cmul(y, cmul(__ldg(a_c + k), __ldg(p_tab + (k << log_t) + l)));  // p_tab is (r, T)
    }
    const size_t g = (static_cast<size_t>(b) << (log_r + log_m)) +
                     (static_cast<size_t>(k) << log_m) + m0 + l;
    yr[g] = y.x;
    yi[g] = y.y;
  }
}

namespace {

bool valid_tile(int log_l, int log_t) {
  const int tile = 1 << (log_l + log_t);
  return log_l >= 1 && tile <= kMaxTile && tile / kPerThread >= 32;
}

template <bool kTwiddle>
int launch_stage(const float* xr, const float* xi, float* yr, float* yi, const void* tw,
                 const void* a_tab, const void* p_tab, long long rows, int log_r, int log_m,
                 int log_t, int log_g, int direction, void* stream) {
  if (rows < 1 || log_g < 0 || log_t < 0 || log_t > log_m || log_m > 30 ||
      !valid_tile(log_r, log_g + log_t) || (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const long long row_blocks = (rows + (1LL << log_g) - 1) >> log_g;
  const long long blocks = row_blocks << (log_m - log_t);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int threads = (1 << (log_r + log_g + log_t)) / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) << (log_r + log_g + log_t);
  cudaError_t err = cudaFuncSetAttribute(fused_stage_kernel<kTwiddle>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_stage_kernel<kTwiddle><<<static_cast<unsigned>(blocks), threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, static_cast<const float2*>(tw), static_cast<const float2*>(a_tab),
      static_cast<const float2*>(p_tab), rows, log_r, log_m, log_t, log_g,
      static_cast<float>(direction));
  return cudaGetLastError();
}

}  // namespace

// One fused stage. x, y: [rows, r*M] float32 planes, r = 2^log_r,
// M = 2^log_m; tw: r float2 twiddles W_r^m; a_tab: (M/T, r) and p_tab:
// (r, T) float2 rank-1 factors of W_{rM}^{k*m} (unread when twiddle is
// 0); T = 2^log_t columns and G = 2^log_g rows per block. Returns a
// cudaError_t.
extern "C" int fftlab_fused_stage(const float* xr, const float* xi, float* yr, float* yi,
                                  const void* tw, const void* a_tab, const void* p_tab,
                                  long long rows, int log_r, int log_m, int log_t, int log_g,
                                  int direction, int twiddle, void* stream) {
  if (twiddle) {
    return launch_stage<true>(xr, xi, yr, yi, tw, a_tab, p_tab, rows, log_r, log_m, log_t,
                              log_g, direction, stream);
  }
  return launch_stage<false>(xr, xi, yr, yi, tw, a_tab, p_tab, rows, log_r, log_m, log_t,
                             log_g, direction, stream);
}
