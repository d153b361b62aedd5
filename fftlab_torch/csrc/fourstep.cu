// fourstep_pass1 / fourstep_pass2 / fourstep_pass2_filter /
// fourstep_pass1_packed / fourstep_pass2_interleaved / fourstep_pass1_swap:
// the two-pass four-step FFT for power-of-two n = L1*L2 in 2^15..2^21
// (L1 <= L2, L1 <= 1024), the FFT -> H -> IFFT sandwich on it, its
// real-signal load and store modes, and the three passes of the huge-n
// FFT (2^21..2^26).
//
// Replaces two TPU kernels that compute one transform:
//   fftlab/kernels/resident_vmem.py `_fft_resident_v6_impl` (one VMEM
//     residency holds the whole 8 MB signal; no Hopper block can, its
//     shared memory ends at 227 KB), and
//   fftlab/kernels/fourstep_vmem.py `_two_pass` (`_pass1_kernel`,
//     `_pass2_kernel`), whose two passes these kernels follow.
// With H multiplied in pass 2's epilogue (fourstep_pass2_filter) they
// also replace the sandwich fftlab/kernels/fourstep_vmem.py
// `_filter_large_impl` (`_two_pass(h2=...)`, `_pass2_filter_kernel`) and
// the one-residency sandwiches of fftlab/kernels/resident_vmem.py
// (`_filter_resident_impl`, `_filter_resident_cio_impl`,
// `_filter_resident_v5_impl`, `_filter_resident_v7_impl`), whose signal
// cannot stay in one block here either. The sandwich is four launches:
// pass 1, pass 2 with H, then pass 1 and pass 2 of the inverse with 1/n.
//
// Pass 1: one block per (batch row b, tile of W consecutive columns j2).
//   It loads x[b, j1, c*W .. c*W+W) for every j1 (W floats = 32 or 64
//   contiguous bytes per j1 at W = 8 or 16), runs the length-L1 FFT down
//   each column in registers and shared memory, multiplies by
//   W_n^{k1*j2} in the rank-1 form A[j2/16, k1] * P[k1, j2 mod 16]
//   (fourstep_vmem._rank1_twiddle_np, float64-built tables), and writes
//   the row-major (B, L1, L2) intermediate.
// Pass 2: one block per (b, tile of R consecutive rows k1). It loads R
//   whole rows, runs the length-L2 FFT along each with the output scale
//   folded into the last pass, and stores element (k2, k1) at
//   k2*L1 + k1: the natural-order spectrum, with the corner turn done by
//   the store (runs of 8 consecutive k1). The filter entry multiplies
//   each output by H[k2*L1 + k1] (natural order) before the store, so
//   the response costs one read of H and no pass of its own.
//
// The real-signal modes fuse the pack-two-reals deinterleave and its
// inverse into the passes (K7's `_pack_impl` / `_interleave_impl` at the
// edges of K6's `_rfft_resident_impl` / `_irfft_resident_impl`, whose
// 8 MB signal cannot stay in one block either): pass 1 with kPackedReal
// reads the real row x[b, 0..2m) as float2 pairs, complex element j =
// (x[2j], x[2j+1]), so W columns are 8*W contiguous bytes per j1;
// pass 2 with kInterleaved stores element k as the float2
// (x[2k], x[2k+1]) of a real row. The fused r2c is pass 1 (packed),
// pass 2, herm_unpack (real.cu): three launches; the c2r is herm_repack,
// pass 1, pass 2 (interleaved) with 1/m in its scale.
//
// The three-pass FFT, n = F1*F2*F3 (threestep_vmem._split_three), replaces
// fftlab/kernels/threestep_vmem.py `_fft_huge_impl` (pallas_call at :204,
// :233, :256) and its blocked form `_fft_huge_blocked` (:387, :414, :440),
// whose blocked intermediates are a TPU DMA layout with the same math. As
// the JAX package does (`_pass_col_kernel = _pass1_kernel`), it reuses the
// two passes above; nothing trigonometric or n-sized is streamed:
//   pass A  pass 1 at L1 = F1, L2 = F2*F3: the column FFT over j1 and
//           W_n^{k1*j23} in rank-1 form -> [b, k1, j2, j3];
//   pass B  pass 1 at L1 = F2, L2 = F3 over batch*F1 rows, the column FFT
//           over j2 and W_{F2F3}^{k2*j3}, with the kSwapStore store: the
//           (k1, k2) swap happens in the store (runs of W floats, as the
//           plain store), not in pass C's load -> [b, k2, k1, j3];
//   pass C  pass 2 at "L1" = F1*F2, L2 = F3: rows k2*F1 + k1 of length F3,
//           stored at k3*F1F2 + k2*F1 + k1 = k1 + F1*k2 + F1F2*k3, the
//           natural order; the output scale rides its last pass.
// Every tile is at most 512*16 = 8192 values (F1, F2 <= 512 at W <= 16;
// F3 <= 512 at R <= 16); all offsets are size_t, so B * 2^26 points index
// safely, and the grid is checked against INT_MAX at launch. Pass A's
// rank-1 factor A is (F2F3/16, F1) float2, 32 MB at 2^26; each block reads
// its own F1 entries, so the table costs 0.5 byte per point (3% of the
// pass's 16).
//
// Bound on this card: device memory. Each pass reads and writes the
// signal once (16 bytes per point per pass, 268 MB at 16 x 2^20 or at
// 1 x 2^24), against about 5 n log2 n flops. Design: the register engine
// of fft_reg.cuh. The first radix-16 pass loads straight from device
// memory into registers (pass 1: W-float runs of 2^g = 8 neighbouring
// columns per row; pass 2: 32 consecutive floats of one row per warp),
// the passes exchange through padded shared-memory planes (2 exchanges
// at L = 512..2048, 1 at 128..256), and the last pass stores straight
// from registers: pass 1 with the rank-1 twiddle, pass 2 with the scale,
// the corner turn (runs of 8 consecutive k1 per k2) and H or the
// interleave. The geometry (W or R, threads, shared bytes, schedule)
// comes from the Python wrappers; with 8K-value tiles two blocks share
// an SM, so one block's loads overlap the other's passes. At 2^20 the
// intermediate of a few rows fits the 50 MB L2; keeping it there on
// purpose (and a blocked intermediate layout) is later work.

#include <climits>

#include "fft_reg.cuh"

using namespace fftlab;

// One pad float every 16, and a row stride of L + L/16 + 4: the tiles'
// exchanges (fft_reg.cuh).
constexpr int kLogPadTiles = 4;

// The rank-1 twiddle tables are built at a width of 16 columns
// (kernels/fourstep_vmem.py PASS1_WIDTH): A is (L2/16, L1), P is (L1, 16).
constexpr int kLogTableWidth = 4;

// The most threads a tile of length-2^kLogL transforms takes (T <= 16).
template <int kLogL>
constexpr int tile_threads() {
  return kLogL >= 10 ? kMaxThreads : 1 << kLogL;
}

// Lanes that hold neighbouring transforms in the passes that touch runs
// of transforms in device memory (fft_reg.cuh `slot_of`): 8 floats, one
// 32-byte sector per plane.
__device__ __forceinline__ int run_bits(int log_t) { return log_t < 3 ? log_t : 3; }

// What pass 1 does at its load and store: kPlainLoad reads the two
// planes; kPackedReal reads xr, a real row of 2*L1*L2 floats, as float2
// pairs (xi unused); kSwapStore reads the two planes of batch row
// bb = o*F1 + k1a and stores output row k1 of it at row (o, k1, k1a) of a
// (batch/F1, L1, F1) row grid: the three-pass kernel's pass B, whose
// (k1, k2) swap rides the store (runs of W floats, as the plain store).
enum Pass1Mode { kPlainLoad, kPackedReal, kSwapStore };

template <int kMode, int kLogL1>
__global__ void __launch_bounds__(tile_threads<kLogL1>(), blocks_per_sm<tile_threads<kLogL1>()>())
fourstep_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ mr, float* __restrict__ mi,
                      const float2* __restrict__ tw1, const float2* __restrict__ a_tab,
                      const float2* __restrict__ p_tab, int log_l2, int log_w, int log_f1,
                      Geometry geo, float sign) {
  constexpr int log_l1 = kLogL1;
  const int log_c = log_l2 - log_w;
  const size_t b = blockIdx.x >> log_c;
  const int j2_0 = (blockIdx.x & ((1 << log_c) - 1)) << log_w;  // first column of the tile
  // 64-bit block bases, 32-bit offsets inside a row of L1*L2 <= 2^26
  const size_t col0 = (b << (log_l1 + log_l2)) + j2_0;
  // kSwapStore: row (o, k1, k1a) = ((o*L1 + k1) << log_f1) + k1a
  const size_t out0 =
      kMode == kSwapStore
          ? ((((b >> log_f1) << (log_f1 + log_l1)) + (b & ((1u << log_f1) - 1))) << log_l2) + j2_0
          : col0;
  const int log_out_row = kMode == kSwapStore ? log_f1 + log_l2 : log_l2;
  float* __restrict__ outr = mr + out0;
  float* __restrict__ outi = mi + out0;
  // W_n^{k1*j2} = A[j2 / 16, k1] * P[k1, j2 mod 16]
  const float2* __restrict__ a_c = a_tab + (static_cast<size_t>(j2_0 >> kLogTableWidth) << log_l1);
  const float2* __restrict__ p_c = p_tab + (j2_0 & ((1 << kLogTableWidth) - 1));
  const int g = run_bits(log_w);
  const Engine<kLogL1, kLogPadTiles> engine{make_tile(log_w, geo), g, g, sign};
  engine.run(
      tw1, 1.0f,
      [&](int t, int j1) {
        const int at = (j1 << log_l2) + t;
        if constexpr (kMode == kPackedReal) {
          return __ldg(reinterpret_cast<const float2*>(xr) + col0 + at);
        } else {
          return make_float2(__ldg(xr + col0 + at), __ldg(xi + col0 + at));
        }
      },
      [&](int t, int k1, float2 y) {
        y = cmul(y, cmul(__ldg(a_c + k1), __ldg(p_c + (k1 << kLogTableWidth) + t)));
        const int at = (k1 << log_out_row) + t;
        outr[at] = y.x;
        outi[at] = y.y;
      });
}

// What pass 2 does at its store: kPlainStore writes the two planes;
// kFilter multiplies each output bin k by hr[k] + i*hi[k] first;
// kInterleaved writes bin k as the float2 (yr[2k], yr[2k+1]) of a real
// row (yi unused). Template parameters, not a runtime branch: a runtime
// null check of H cost the plain pass 2 six registers.
enum Pass2Mode { kPlainStore, kFilter, kInterleaved };

template <int kMode, int kLogL2>
__global__ void __launch_bounds__(tile_threads<kLogL2>(), blocks_per_sm<tile_threads<kLogL2>()>())
fourstep_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                      float* __restrict__ yr, float* __restrict__ yi,
                      const float2* __restrict__ tw2, const float* __restrict__ hr,
                      const float* __restrict__ hi, int log_l1, int log_r, Geometry geo,
                      float sign, float scale) {
  constexpr int log_l2 = kLogL2;
  const int log_g = log_l1 - log_r;
  const int k1_0 = (blockIdx.x & ((1 << log_g) - 1)) << log_r;
  const size_t base = static_cast<size_t>(blockIdx.x >> log_g) << (log_l1 + log_l2);
  // 64-bit block bases, 32-bit offsets inside a row of L1*L2 <= 2^26
  const size_t row0 = base + (static_cast<size_t>(k1_0) << log_l2);
  const size_t out0 = base + k1_0;
  const Engine<kLogL2, kLogPadTiles> engine{make_tile(log_r, geo), 0, run_bits(log_r), sign};
  engine.run(
      tw2, scale,
      // R whole rows: a warp reads 32 consecutive floats of one row
      [&](int r, int j2) {
        const int at = (r << log_l2) + j2;
        return make_float2(__ldg(mr + row0 + at), __ldg(mi + row0 + at));
      },
      // element (k2, r) -> natural index k = k2*L1 + k1_0 + r
      [&](int r, int k2, float2 v) {
        const int k = (k2 << log_l1) + r;  // minus k1_0
        if constexpr (kMode == kFilter) {
          v = cmul(v, make_float2(__ldg(hr + k1_0 + k), __ldg(hi + k1_0 + k)));
        }
        if constexpr (kMode == kInterleaved) {
          reinterpret_cast<float2*>(yr)[out0 + k] = v;
        } else {
          yr[out0 + k] = v.x;
          yi[out0 + k] = v.y;
        }
      });
}

namespace {

// Set a kernel's shared memory and launch it on `grid` blocks of the
// geometry's threads.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, long long grid, const Geometry& geo, void* stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), geo.threads, geo.smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// batch: rows of L1*L2 the kernel transforms (for kSwapStore, F1 times
// the caller's batch).
template <int kMode>
int launch_pass1(const float* xr, const float* xi, float* mr, float* mi, const void* tw1,
                 const void* a_tab, const void* p_tab, long long batch, int log_l1, int log_l2,
                 int log_w, int log_f1, Geometry geo, int direction, void* stream) {
  const long long blocks = batch << (log_l2 - log_w);
  if (!valid_geometry(geo, log_l1, log_w, kLogPadTiles) || log_w > kLogTableWidth ||
      log_w < 2 || log_l2 < kLogTableWidth || log_l2 > 26 || batch < 1 || blocks > INT_MAX ||
      log_f1 < 0 || (batch & ((1LL << log_f1) - 1)) != 0 ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  return dispatch<7, 10>(log_l1, [&](auto log_l1_c) {
    return launch(fourstep_pass1_kernel<kMode, decltype(log_l1_c)::value>, blocks, geo, stream,
                  xr, xi, mr, mi, static_cast<const float2*>(tw1),
                  static_cast<const float2*>(a_tab), static_cast<const float2*>(p_tab), log_l2,
                  log_w, log_f1, geo, static_cast<float>(direction));
  });
}

}  // namespace

// Pass 1. x: [batch, L1*L2] float32 planes; m: the (batch, L1, L2)
// intermediate planes; tw1: the engine's twiddle table for L1; a_tab:
// (L2/16, L1) and p_tab: (L1, 16) float2 rank-1 twiddle factors; W =
// 2^log_w <= 16 columns per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `pass1_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1(const float* xr, const float* xi, float* mr, float* mi,
                                     const void* tw1, const void* a_tab, const void* p_tab,
                                     long long batch, int log_l1, int log_l2, int log_w,
                                     Geometry geo, int direction, void* stream) {
  return launch_pass1<kPlainLoad>(xr, xi, mr, mi, tw1, a_tab, p_tab, batch, log_l1, log_l2,
                                  log_w, 0, geo, direction, stream);
}

// Pass 1 of a packed real signal. x: [batch, 2*L1*L2] float32 (8-byte
// aligned), complex element j = (x[2j], x[2j+1]); the rest as
// fftlab_fourstep_pass1. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1_packed(const float* x, float* mr, float* mi,
                                            const void* tw1, const void* a_tab,
                                            const void* p_tab, long long batch, int log_l1,
                                            int log_l2, int log_w, Geometry geo, int direction,
                                            void* stream) {
  return launch_pass1<kPackedReal>(x, nullptr, mr, mi, tw1, a_tab, p_tab, batch, log_l1, log_l2,
                                   log_w, 0, geo, direction, stream);
}

// Pass B of the three-pass FFT: pass 1 of batch*F1 rows of L1*L2 (row
// bb = o*F1 + k1a), its output row k1 stored at row (o, k1, k1a) of the
// (batch, L1, F1) row grid, F1 = 2^log_f1: the (k1a, k1) axes swap on the
// store. Planes and tables as fftlab_fourstep_pass1. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1_swap(const float* xr, const float* xi, float* mr, float* mi,
                                          const void* tw1, const void* a_tab, const void* p_tab,
                                          long long batch, int log_f1, int log_l1, int log_l2,
                                          int log_w, Geometry geo, int direction, void* stream) {
  if (batch < 1 || log_f1 < 0 || log_f1 > 20) return cudaErrorInvalidValue;
  return launch_pass1<kSwapStore>(xr, xi, mr, mi, tw1, a_tab, p_tab, batch << log_f1, log_l1,
                                  log_l2, log_w, log_f1, geo, direction, stream);
}

namespace {

// Pass 2, with the store of `kMode`.
template <int kMode>
int launch_pass2(const float* mr, const float* mi, float* yr, float* yi, const void* tw2,
                 const float* hr, const float* hi, long long batch, int log_l1, int log_l2,
                 int log_r, Geometry geo, int direction, float scale, void* stream) {
  const long long blocks = batch << (log_l1 - log_r);
  if (!valid_geometry(geo, log_l2, log_r, kLogPadTiles) || log_r > log_l1 || log_r < 1 ||
      log_l1 + log_l2 > 26 || batch < 1 || blocks > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  return dispatch<7, 11>(log_l2, [&](auto log_l2_c) {
    return launch(fourstep_pass2_kernel<kMode, decltype(log_l2_c)::value>, blocks, geo, stream,
                  mr, mi, yr, yi, static_cast<const float2*>(tw2), hr, hi, log_l1, log_r, geo,
                  static_cast<float>(direction), scale);
  });
}

}  // namespace

// Pass 2. m: the (batch, L1, L2) intermediate planes; y: [batch, L1*L2]
// natural-order output planes; tw2: the engine's twiddle table for L2;
// R = 2^log_r rows per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `pass2_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2(const float* mr, const float* mi, float* yr, float* yi,
                                     const void* tw2, long long batch, int log_l1, int log_l2,
                                     int log_r, Geometry geo, int direction, float scale,
                                     void* stream) {
  return launch_pass2<kPlainStore>(mr, mi, yr, yi, tw2, nullptr, nullptr, batch, log_l1,
                                   log_l2, log_r, geo, direction, scale, stream);
}

// Pass 2 with the spectral response in its epilogue: as
// fftlab_fourstep_pass2, then output bin k times hr[k] + i*hi[k] (n float32
// each, natural order). Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2_filter(const float* mr, const float* mi, float* yr,
                                            float* yi, const void* tw2, const float* hr,
                                            const float* hi, long long batch, int log_l1,
                                            int log_l2, int log_r, Geometry geo, int direction,
                                            float scale, void* stream) {
  if (hr == nullptr || hi == nullptr) return cudaErrorInvalidValue;
  return launch_pass2<kFilter>(mr, mi, yr, yi, tw2, hr, hi, batch, log_l1, log_l2, log_r, geo,
                               direction, scale, stream);
}

// Pass 2 into a real signal: as fftlab_fourstep_pass2, with output bin k
// stored as the float2 (y[2k], y[2k+1]) of y: [batch, 2*L1*L2] float32
// (8-byte aligned). Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2_interleaved(const float* mr, const float* mi, float* y,
                                                 const void* tw2, long long batch, int log_l1,
                                                 int log_l2, int log_r, Geometry geo,
                                                 int direction, float scale, void* stream) {
  return launch_pass2<kInterleaved>(mr, mi, y, nullptr, tw2, nullptr, nullptr, batch, log_l1,
                                    log_l2, log_r, geo, direction, scale, stream);
}

// Message for a cudaError_t returned by the functions above.
extern "C" const char* fftlab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
