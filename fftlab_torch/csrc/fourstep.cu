// fourstep_pass1 / fourstep_pass2 / fourstep_pass2_sandwich /
// fourstep_pass1_packed / fourstep_pass2_interleaved / fourstep_pass1_swap
// / fused_stage / stage_leaf: the two-pass four-step FFT for power-of-two
// n = L1*L2 in 2^15..2^21 (L1 <= L2, L1 <= 1024), the FFT -> H -> IFFT
// sandwich on it, its real-signal load and store modes, the three passes
// of the huge-n FFT (2^21..2^26), and the stages and leaf of the stage
// pipeline.
//
// Replaces two TPU kernels that compute one transform:
//   fftlab/kernels/resident_vmem.py `_fft_resident_v6_impl` (one VMEM
//     residency holds the whole 8 MB signal; no Hopper block can, its
//     shared memory ends at 227 KB), and
//   fftlab/kernels/fourstep_vmem.py `_two_pass` (`_pass1_kernel`,
//     `_pass2_kernel`), whose two passes these kernels follow.
// With pass 2's sandwich mode (fourstep_pass2_sandwich) they also replace
// the sandwich fftlab/kernels/fourstep_vmem.py `_filter_large_impl`
// (`_two_pass(h2=...)`, `_pass2_filter_kernel`) and the one-residency
// sandwiches of fftlab/kernels/resident_vmem.py (`_filter_resident_impl`,
// `_filter_resident_cio_impl`, `_filter_resident_v5_impl`,
// `_filter_resident_v7_impl`), whose signal cannot stay in one block here
// either. The sandwich is three launches, the three phases of the
// resident kernels (`_resident_filter_kernel`: the column FFT, `_mid`,
// the inverse column FFT):
//   pass 1     the forward column FFT and W_n^{k1*j2}, as below;
//   sandwich   per row k1: the forward length-L2 FFT, times
//              H[k2*L1 + k1], the inverse length-L2 FFT, then
//              W_n^{-k1*j2}/n, stored back over the row (no corner turn);
//   pass 1     the inverse column FFT with no twiddle (kNoTwiddle), whose
//              store k1*L2 + j2 is already the natural order.
// x[L2*j1 + j2] = (1/n) sum_k1 W_L1^{-j1*k1} W_n^{-j2*k1} sum_k2
// Y[k1 + L1*k2] W_L2^{-j2*k2}, Y = X*H: the inverse's index splits as the
// forward's, so the middle step needs no corner turn, and the sandwich
// moves 48 bytes a point where pass 1, pass 2 with H, and the inverse's
// two passes moved 64.
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
//   the store (runs of 8 consecutive k1).
// Pass 2's sandwich mode (fourstep_pass2_sandwich): one block per (b,
//   tile of R consecutive rows k1), in place. It loads R whole rows as
//   pass 2 does (slot mapping 0: a warp reads 32 consecutive floats of one
//   row), runs the forward length-L2 FFT with its spectrum left in the
//   exchange planes (sandwich.cuh), and the inverse's first pass reads it
//   times H[k2*L1 + k1] under slot mapping run_bits(R): min(R, 8)
//   neighbouring threads on as many neighbouring rows k1 of one k2, so a
//   warp's H reads are whole 32-byte sectors at R >= 8 and half sectors at
//   R = 4 (under slot mapping 0 each float would take a sector of its own,
//   L1 floats from the next). The inverse's later passes keep that
//   mapping, its last pass takes 0, and its store puts row k1 back at
//   k1*L2 + j2 times A[j2/16, k1] * P[k1, j2 mod 16] = W_n^{-k1*j2}/n
//   (pass 1's rank-1 tables built for the inverse, 1/n folded into P):
//   runs of 32 consecutive floats a warp (16 at L2 = 256). In the padded
//   tile (a row stride of L2 + L2/16 + 8 at R = 4) every exchange then
//   takes one wavefront per 32 floats but two: the forward's first store
//   at L2 <= 256 (as pass 2's) and the inverse's last loads
//   (tests/test_torch_geometry.py). A block owns its R rows and has read
//   all of them before its first store, so it writes over its input; the
//   planes are not __restrict__ and are read with plain loads, not the
//   read-only path.
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
// The stage pipeline, n = r_1*...*r_K (kernels/stage_fused.py), replaces
// fftlab/kernels/stage_fused.py `fused_stage` (pallas_call at :96,
// `_stage_kernel`) and the leaf contraction and digit reversal that the
// JAX package's `fft_split_pipeline` runs outside any Pallas kernel. It
// is the same launch sequence as the three passes, in general:
//   stage i  pass 1 at (L1, L2) = (r_i, M_i) in kStage mode, the column
//            FFT over the leading digit and W^{k*m} in rank-1 form; from
//            the second stage on with pass B's swap store, F1 = r_1*...*
//            r_{i-1}, so the rows reach the leaf in the order
//            (k_{K-1}, ..., k_1);
//   leaf     pass 2 at ("L1", L2) = (n/leaf, leaf) in kLeaf mode: its
//            store at k_K*(n/leaf) + row is the natural order, so the
//            digit reversal costs no pass, and the scale rides its last
//            pass.
// K launches, one read and one write of the signal each; at 2^21 the
// factors (128, 128, 128) are `_split_three`'s. A stage's block takes
// 4096 values (256 threads): G = 256/r rows of 16 columns, so the short
// stages of the pipelines from 2^15 to 2^20 ((128, 2..64, 128)) fill a
// block, where one tile of 16 columns at r = 2 would be 2 threads. Lengths
// 32 and 64 take the engine's two passes (one exchange), 2..16 one pass
// in registers (`Engine::run_short`, 16/r columns a thread). The leaf's
// block takes R = 4096/leaf rows (at least 8) of any batch rows, so a leaf
// of 2 or 4 rows (n = 256, 512) still fills a block. Bound on this card:
// device memory, as for every pass here (16 bytes a point a launch).
// Tensor cores would not help: a radix-r stage does about 5 log2 r flops
// a point, and the TPU kernel's contraction with F_r would do 8r.
//
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
// the corner turn (runs of 8 consecutive k1 per k2) or the interleave.
// The sandwich mode reads and writes the signal once too, and H (8 bytes
// a point of one batch row, L2-resident across batch rows) once a batch
// row. The geometry (W or R, threads, shared bytes, schedule) comes from
// the Python wrappers; with 8K-value tiles two blocks share an SM, so one
// block's loads overlap the other's passes. At 2^20 the intermediate of
// a few rows fits the 50 MB L2; keeping it there on purpose (and a
// blocked intermediate layout) is later work.

#include <climits>

#include "sandwich.cuh"

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
// kStage is one stage of the stage pipeline (`stage_tile`). kNoTwiddle is
// kPlainLoad without the twiddle: the sandwich's inverse pass 1, whose
// input carries W_n^{-k1*j2} from the sandwich mode (multiplying by
// tables of ones instead cost 10-25% of the pass on an H100 at 700 W).
enum Pass1Mode { kPlainLoad, kPackedReal, kSwapStore, kStage, kNoTwiddle };

// The threads of a stage's block (kStage) and of a leaf's block at its
// shortest length (kLeaf): a tile of 4096 values.
constexpr int kStageThreads = 256;

// The most threads a block of pass 1 in `kMode` takes.
template <int kMode, int kLogL1>
constexpr int pass1_threads() {
  return kMode == kStage ? kStageThreads : tile_threads<kLogL1>();
}

// Pass 1 as one radix-L1 stage of the stage pipeline, L1 = 2..128, over
// `rows` batch rows of L1*L2 (kernels/stage_fused.py): a block takes the
// same 16 columns j2 (one entry of the rank-1 factor A per k1) of G =
// 2^log_g consecutive rows, T = 16*G = 4096/L1 transforms, transform t in
// row b0 + t/16 and column j2_0 + t%16; rows past the batch load zeros
// and store nothing. Slot mapping 4 puts 16 neighbouring threads on a
// row's 16 columns, one 64-byte run per plane, in the first pass's loads
// and the last pass's stores. Output row k1 of row b = o*F1 + k1a goes to
// row (o, k1, k1a), F1 = 2^log_f1: F1 = 1 is the plain pass-1 store (the
// first stage), F1 = r_1*...*r_{i-1} the swap store of stage i, so the
// rows reach the leaf in the order (k_{K-1}, ..., k_1). Lengths of at
// most 16 run as `Engine::run_short` (no exchange, no shared memory).
template <int kLogL1>
__device__ __forceinline__ void stage_tile(const float* __restrict__ xr,
                                           const float* __restrict__ xi, float* __restrict__ mr,
                                           float* __restrict__ mi, const float2* __restrict__ tw1,
                                           const float2* __restrict__ a_tab,
                                           const float2* __restrict__ p_tab, int log_l2,
                                           int log_f1, const Geometry& geo, float sign,
                                           long long rows, int log_g) {
  constexpr int log_l1 = kLogL1;
  constexpr int log_w = kLogTableWidth;
  const int log_c = log_l2 - log_w;
  const long long b0 = static_cast<long long>(blockIdx.x >> log_c) << log_g;
  const int c = blockIdx.x & ((1 << log_c) - 1);
  const int j2_0 = c << log_w;
  const float2* __restrict__ a_c = a_tab + (static_cast<size_t>(c) << log_l1);
  const size_t f1_mask = (size_t{1} << log_f1) - 1;
  const Engine<kLogL1, kLogPadTiles> engine{make_tile(log_g + log_w, geo), log_w, log_w, sign};
  const auto load = [&](int t, int j1) {
    const long long b = b0 + (t >> log_w);
    if (b >= rows) return make_float2(0.0f, 0.0f);
    const size_t at = (static_cast<size_t>(b) << (log_l1 + log_l2)) +
                      (static_cast<size_t>(j1) << log_l2) + j2_0 + (t & 15);
    return make_float2(__ldg(xr + at), __ldg(xi + at));
  };
  const auto store = [&](int t, int k1, float2 y) {
    const long long b = b0 + (t >> log_w);
    if (b >= rows) return;
    const int l = t & 15;
    y = cmul(y, cmul(__ldg(a_c + k1), __ldg(p_tab + (k1 << log_w) + l)));
    const size_t row = ((static_cast<size_t>(b) & ~f1_mask) << log_l1) +
                       (static_cast<size_t>(k1) << log_f1) + (static_cast<size_t>(b) & f1_mask);
    const size_t at = (row << log_l2) + j2_0 + l;
    mr[at] = y.x;
    mi[at] = y.y;
  };
  if constexpr (kLogL1 <= 4) {
    engine.template run_short<kStageThreads>(load, store);
  } else {
    engine.run(tw1, 1.0f, load, store);
  }
}

// Pass 1 in the other modes: a block takes W = 2^log_w consecutive
// columns of one batch row.
template <int kMode, int kLogL1>
__device__ __forceinline__ void column_tile(const float* __restrict__ xr,
                                            const float* __restrict__ xi, float* __restrict__ mr,
                                            float* __restrict__ mi,
                                            const float2* __restrict__ tw1,
                                            const float2* __restrict__ a_tab,
                                            const float2* __restrict__ p_tab, int log_l2,
                                            int log_w, int log_f1, const Geometry& geo,
                                            float sign) {
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
        if constexpr (kMode != kNoTwiddle) {
          y = cmul(y, cmul(__ldg(a_c + k1), __ldg(p_c + (k1 << kLogTableWidth) + t)));
        }
        const int at = (k1 << log_out_row) + t;
        outr[at] = y.x;
        outi[at] = y.y;
      });
}

template <int kMode, int kLogL1>
__global__ void __launch_bounds__(pass1_threads<kMode, kLogL1>(),
                                  blocks_per_sm<pass1_threads<kMode, kLogL1>()>())
fourstep_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ mr, float* __restrict__ mi,
                      const float2* __restrict__ tw1, const float2* __restrict__ a_tab,
                      const float2* __restrict__ p_tab, int log_l2, int log_w, int log_f1,
                      Geometry geo, float sign, long long rows, int log_g) {
  if constexpr (kMode == kStage) {
    stage_tile<kLogL1>(xr, xi, mr, mi, tw1, a_tab, p_tab, log_l2, log_f1, geo, sign, rows, log_g);
  } else {
    column_tile<kMode, kLogL1>(xr, xi, mr, mi, tw1, a_tab, p_tab, log_l2, log_w, log_f1, geo,
                               sign);
  }
}

// What pass 2 does at its store: kPlainStore writes the two planes;
// kInterleaved writes bin k as the float2 (yr[2k], yr[2k+1]) of a real
// row (yi unused). Template parameters, not a runtime branch. kLeaf is the
// stage pipeline's leaf (`leaf_tile`). The sandwich mode is a kernel of
// its own (`fourstep_pass2_sandwich_kernel`): its input and output are
// the same planes, which this kernel's __restrict__ parameters exclude.
enum Pass2Mode { kPlainStore, kInterleaved, kLeaf };

// The most threads a block of pass 2 in `kMode` takes.
template <int kMode, int kLogL2>
constexpr int pass2_threads() {
  return kMode == kLeaf && tile_threads<kLogL2>() < kStageThreads ? kStageThreads
                                                                   : tile_threads<kLogL2>();
}

// Pass 2 as the leaf of the stage pipeline: the length-L2 FFT of each of
// the `rows` = batch*L1 rows q = b*L1 + k1 (the rows of the last stage,
// in the order (k_{K-1}, ..., k_1) within a batch row b), element k2
// stored at k2*L1 + k1 of batch row b: the natural order, the digit
// reversal done by the store. A block takes R = 2^log_r consecutive rows
// of any batch rows, so a leaf whose L1 is below R (n/leaf = 2, 4, 8 at
// n = 256, 512, 1024) fills its block from several batch rows; rows past
// the end load zeros and store nothing. The output scale rides the last
// pass, as in the plain pass 2.
template <int kLogL2>
__device__ __forceinline__ void leaf_tile(const float* __restrict__ mr,
                                          const float* __restrict__ mi, float* __restrict__ yr,
                                          float* __restrict__ yi, const float2* __restrict__ tw2,
                                          int log_l1, int log_r, const Geometry& geo, float sign,
                                          float scale, long long rows) {
  constexpr int log_l2 = kLogL2;
  const long long q0 = static_cast<long long>(blockIdx.x) << log_r;
  const size_t k1_mask = (size_t{1} << log_l1) - 1;
  const Engine<kLogL2, kLogPadTiles> engine{make_tile(log_r, geo), 0, run_bits(log_r), sign};
  engine.run(
      tw2, scale,
      // a warp reads 32 consecutive floats of one row
      [&](int r, int j2) {
        const long long q = q0 + r;
        if (q >= rows) return make_float2(0.0f, 0.0f);
        const size_t at = (static_cast<size_t>(q) << log_l2) + j2;
        return make_float2(__ldg(mr + at), __ldg(mi + at));
      },
      [&](int r, int k2, float2 v) {
        const long long q = q0 + r;
        if (q >= rows) return;
        const size_t at = ((static_cast<size_t>(q) & ~k1_mask) << log_l2) +
                          (static_cast<size_t>(k2) << log_l1) + (static_cast<size_t>(q) & k1_mask);
        yr[at] = v.x;
        yi[at] = v.y;
      });
}

// Pass 2 in the other modes: a block takes R = 2^log_r consecutive rows k1
// of one batch row.
template <int kMode, int kLogL2>
__device__ __forceinline__ void row_tile(const float* __restrict__ mr,
                                         const float* __restrict__ mi, float* __restrict__ yr,
                                         float* __restrict__ yi, const float2* __restrict__ tw2,
                                         int log_l1, int log_r, const Geometry& geo, float sign,
                                         float scale) {
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
        if constexpr (kMode == kInterleaved) {
          reinterpret_cast<float2*>(yr)[out0 + k] = v;
        } else {
          yr[out0 + k] = v.x;
          yi[out0 + k] = v.y;
        }
      });
}

template <int kMode, int kLogL2>
__global__ void __launch_bounds__(pass2_threads<kMode, kLogL2>(),
                                  blocks_per_sm<pass2_threads<kMode, kLogL2>()>())
fourstep_pass2_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                      float* __restrict__ yr, float* __restrict__ yi,
                      const float2* __restrict__ tw2, int log_l1, int log_r, Geometry geo,
                      float sign, float scale, long long rows) {
  if constexpr (kMode == kLeaf) {
    leaf_tile<kLogL2>(mr, mi, yr, yi, tw2, log_l1, log_r, geo, sign, scale, rows);
  } else {
    row_tile<kMode, kLogL2>(mr, mi, yr, yi, tw2, log_l1, log_r, geo, sign, scale);
  }
}

// Pass 2's sandwich mode: block b*(L1/R) + c takes the R = 2^log_r rows
// k1 = c*R .. c*R + R - 1 of batch row b of the (batch, L1, L2)
// intermediate m and writes each back over itself as
// W_n^{-k1*j2}/n * IFFT_L2(FFT_L2(row) * H[k2*L1 + k1]) (the slot
// mappings at the top of this file). tw_fwd, tw_inv: the engine's tables
// of L2; a_tab (L2/16, L1) and p_tab (L1, 16): W_n^{-k1*j2}/n in rank-1
// form.
template <int kLogL2>
__global__ void __launch_bounds__(tile_threads<kLogL2>(), blocks_per_sm<tile_threads<kLogL2>()>())
fourstep_pass2_sandwich_kernel(float* mr, float* mi, const float2* __restrict__ tw_fwd,
                               const float2* __restrict__ tw_inv, const float* __restrict__ hr,
                               const float* __restrict__ hi, const float2* __restrict__ a_tab,
                               const float2* __restrict__ p_tab, int log_l1, int log_r,
                               Geometry geo) {
  constexpr int log_l2 = kLogL2;
  const int log_g = log_l1 - log_r;
  const int k1_0 = (blockIdx.x & ((1 << log_g) - 1)) << log_r;
  // 64-bit block bases, 32-bit offsets inside a row of L1*L2 <= 2^26
  const size_t row0 = (static_cast<size_t>(blockIdx.x >> log_g) << (log_l1 + log_l2)) +
                      (static_cast<size_t>(k1_0) << log_l2);
  sandwich<kLogL2, kLogPadTiles>(
      make_tile(log_r, geo), tw_fwd, tw_inv, 1.0f, run_bits(log_r),
      // R whole rows: a warp reads 32 consecutive floats of one row
      [&](int t, int e) {
        const int at = (t << log_l2) + e;
        return make_float2(mr[row0 + at], mi[row0 + at]);
      },
      // H[k2*L1 + k1], k2 = e, k1 = k1_0 + t: runs of min(R, 8) k1 a warp
      [&](int t, int e) {
        const int k = (e << log_l1) + k1_0 + t;
        return make_float2(__ldg(hr + k), __ldg(hi + k));
      },
      [&](int z) {
        const int b = blockIdx.x + z;
        const int k0 = (b & ((1 << log_g) - 1)) << log_r;
        const size_t at0 = (static_cast<size_t>(b >> log_g) << (log_l1 + log_l2)) +
                           (static_cast<size_t>(k0) << log_l2);
        return [yr = mr + at0, yi = mi + at0, a_c = a_tab + k0,
                p_c = p_tab + (static_cast<size_t>(k0) << kLogTableWidth), log_l1](
                   int t, int e, float2 y) {
          y = cmul(y, cmul(__ldg(a_c + ((e >> kLogTableWidth) << log_l1) + t),
                           __ldg(p_c + (t << kLogTableWidth) + (e & ((1 << kLogTableWidth) - 1)))));
          const int at = (t << kLogL2) + e;
          yr[at] = y.x;
          yi[at] = y.y;
        };
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
                  log_w, log_f1, geo, static_cast<float>(direction), batch, 0);
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

// Pass 1 with no twiddle (kNoTwiddle): the column FFTs alone, stored at
// k1*L2 + j2. Planes, tw1 and the rest as fftlab_fourstep_pass1. Returns
// a cudaError_t.
extern "C" int fftlab_fourstep_pass1_no_twiddle(const float* xr, const float* xi, float* mr,
                                                float* mi, const void* tw1, long long batch,
                                                int log_l1, int log_l2, int log_w, Geometry geo,
                                                int direction, void* stream) {
  return launch_pass1<kNoTwiddle>(xr, xi, mr, mi, tw1, nullptr, nullptr, batch, log_l1, log_l2,
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
                 long long batch, int log_l1, int log_l2, int log_r, Geometry geo,
                 int direction, float scale, void* stream) {
  const long long blocks = batch << (log_l1 - log_r);
  if (!valid_geometry(geo, log_l2, log_r, kLogPadTiles) || log_r > log_l1 || log_r < 1 ||
      log_l1 + log_l2 > 26 || batch < 1 || blocks > INT_MAX ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  return dispatch<7, 11>(log_l2, [&](auto log_l2_c) {
    return launch(fourstep_pass2_kernel<kMode, decltype(log_l2_c)::value>, blocks, geo, stream,
                  mr, mi, yr, yi, static_cast<const float2*>(tw2), log_l1, log_r, geo,
                  static_cast<float>(direction), scale, batch << log_l1);
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
  return launch_pass2<kPlainStore>(mr, mi, yr, yi, tw2, batch, log_l1, log_l2, log_r, geo,
                                   direction, scale, stream);
}

// Pass 2's sandwich mode, in place. m: the (batch, L1, L2) intermediate
// planes of pass 1 (forward), overwritten with the input of the inverse's
// pass 1; tw_fwd, tw_inv: the engine's twiddle tables for L2, forward and
// inverse; hr, hi: the n-point response in natural bin order; a_tab:
// (L2/16, L1) and p_tab: (L1, 16) float2, W_n^{-k1*j2}/n in rank-1 form;
// R = 2^log_r rows per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `sandwich_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2_sandwich(float* mr, float* mi, const void* tw_fwd,
                                              const void* tw_inv, const float* hr,
                                              const float* hi, const void* a_tab,
                                              const void* p_tab, long long batch, int log_l1,
                                              int log_l2, int log_r, Geometry geo,
                                              void* stream) {
  const long long blocks = batch << (log_l1 - log_r);
  if (hr == nullptr || hi == nullptr || !valid_geometry(geo, log_l2, log_r, kLogPadTiles) ||
      log_r > log_l1 || log_r < 1 || log_l2 < kLogTableWidth || log_l1 + log_l2 > 26 ||
      batch < 1 || blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  return dispatch<7, 11>(log_l2, [&](auto log_l2_c) {
    return launch(fourstep_pass2_sandwich_kernel<decltype(log_l2_c)::value>, blocks, geo,
                  stream, mr, mi, static_cast<const float2*>(tw_fwd),
                  static_cast<const float2*>(tw_inv), hr, hi, static_cast<const float2*>(a_tab),
                  static_cast<const float2*>(p_tab), log_l1, log_r, geo);
  });
}

// Pass 2 into a real signal: as fftlab_fourstep_pass2, with output bin k
// stored as the float2 (y[2k], y[2k+1]) of y: [batch, 2*L1*L2] float32
// (8-byte aligned). Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2_interleaved(const float* mr, const float* mi, float* y,
                                                 const void* tw2, long long batch, int log_l1,
                                                 int log_l2, int log_r, Geometry geo,
                                                 int direction, float scale, void* stream) {
  return launch_pass2<kInterleaved>(mr, mi, y, nullptr, tw2, batch, log_l1, log_l2, log_r, geo,
                                    direction, scale, stream);
}

// One stage of the stage pipeline: pass 1 in kStage mode (`stage_tile`).
// x: [rows, L1*L2] float32 planes, L1 = 2^log_l1 in 2..128, L2 =
// 2^log_l2 >= 16; y: the same shape, output row k1 of input row
// o*F1 + k1a stored at row (o, k1, k1a), F1 = 2^log_f1 dividing rows
// (F1 = 1: the plain pass-1 store); tw1, a_tab, p_tab: as
// fftlab_fourstep_pass1 (A and P of ones: no twiddle); G = 2^log_g rows
// of 16 columns per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `stage_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fused_stage(const float* xr, const float* xi, float* yr, float* yi,
                                  const void* tw1, const void* a_tab, const void* p_tab,
                                  long long rows, int log_f1, int log_l1, int log_l2, int log_g,
                                  Geometry geo, int direction, void* stream) {
  if (rows < 1 || rows > INT_MAX || log_f1 < 0 || log_f1 > 30 ||
      (rows & ((1LL << log_f1) - 1)) != 0 || log_g < 0 || log_l2 < kLogTableWidth ||
      log_l2 > 26 || geo.threads != kStageThreads ||
      !valid_geometry(geo, log_l1, log_g + kLogTableWidth, kLogPadTiles, 11) ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = ((rows + (1LL << log_g) - 1) >> log_g) << (log_l2 - kLogTableWidth);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return dispatch<1, 7>(log_l1, [&](auto log_l1_c) {
    return launch(fourstep_pass1_kernel<kStage, decltype(log_l1_c)::value>, blocks, geo, stream,
                  xr, xi, yr, yi, static_cast<const float2*>(tw1),
                  static_cast<const float2*>(a_tab), static_cast<const float2*>(p_tab), log_l2,
                  kLogTableWidth, log_f1, geo, static_cast<float>(direction), rows, log_g);
  });
}

// The leaf of the stage pipeline: pass 2 in kLeaf mode (`leaf_tile`).
// m: [batch, L1*L2] float32 planes, the batch*L1 rows of length L2 =
// 2^log_l2 in 128..2048 that the last stage left; y: the natural-order
// spectrum [batch, L1*L2], times `scale`; tw2: the engine's twiddle table
// for L2; R = 2^log_r rows per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `leaf_geometry`. Returns a cudaError_t.
extern "C" int fftlab_stage_leaf(const float* mr, const float* mi, float* yr, float* yi,
                                 const void* tw2, long long batch, int log_l1, int log_l2,
                                 int log_r, Geometry geo, int direction, float scale,
                                 void* stream) {
  if (batch < 1 || batch > INT_MAX || log_l1 < 0 || log_l1 + log_l2 > 30 ||
      !valid_geometry(geo, log_l2, log_r, kLogPadTiles, 5) ||
      (direction != 1 && direction != -1)) {
    return cudaErrorInvalidValue;
  }
  const long long rows = batch << log_l1;
  const long long blocks = (rows + (1LL << log_r) - 1) >> log_r;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return dispatch<7, 11>(log_l2, [&](auto log_l2_c) {
    constexpr int kLogL2 = decltype(log_l2_c)::value;
    if (geo.threads > pass2_threads<kLeaf, kLogL2>()) return cudaErrorInvalidValue;
    return launch(fourstep_pass2_kernel<kLeaf, kLogL2>, blocks, geo, stream, mr, mi, yr, yi,
                  static_cast<const float2*>(tw2), log_l1, log_r, geo,
                  static_cast<float>(direction), scale, rows);
  });
}

// Message for a cudaError_t returned by the functions above.
extern "C" const char* fftlab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
