// fourstep_pass1 / fourstep_pass2 / fourstep_pass2_sandwich /
// fourstep_pass1_packed / fourstep_pass2_interleaved / fourstep_pass2_unpack
// / fourstep_pass1_swap / fused_stage / stage_leaf: the two-pass four-step
// FFT for power-of-two n = L1*L2 in 2^15..2^21 (L1 <= L2, L1 <= 1024), the
// FFT -> H -> IFFT sandwich on it, its real-signal load and store modes,
// the three passes of the huge-n FFT (2^21..2^26), and the stages and leaf
// of the stage pipeline.
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
//   W_n^{k1*j2}, and writes the row-major (B, L1, L2) intermediate. At
//   L1 >= 512 the twiddle is S[k1 mod U, j2] * S[U + k1 div U, j2] (U =
//   2^ceil(log2 L1 / 2); fourstep_vmem._staged_twiddle_np, a float64-built
//   table of U + L1/U rows): the block's W columns of S (4 KB at L1 =
//   1024, W = 8) are staged in shared memory beside the first pass's
//   loads, and the store reads both factors there. At L1 <= 256 it is
//   the rank-1 A[j2/16, k1] * P[k1, j2 mod 16]
//   (fourstep_vmem._rank1_twiddle_np), read straight by the store: P
//   (L1 x 16, 32 KB at most) stays in L1, and S would cost a block more
//   table than A's row does (`column_tile`).
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
// (x[2k], x[2k+1]) of a real row. The fused r2c is pass 1 (packed) and
// pass 2's unpack mode (fourstep_pass2_unpack), which does the Hermitian
// unpack of herm_unpack (real.cu) in its epilogue: two launches, and the
// half-size spectrum Z never reaches device memory. The c2r is
// herm_repack, pass 1, pass 2 (interleaved) with 1/m in its scale.
// Pass 2's unpack mode: bin k = k2*L1 + k1 and its mirror m - k =
//   (L2-1-k2)*L1 + (L1-k1) lie in rows k1 and L1 - k1 (k1 != 0); rows 0 and
//   L1/2 each pair with themselves (k2 with L2 - k2, and with L2-1-k2).
//   Block b*(L1/R) + c takes the R/2 rows k1 = c*R/2 + u (u < R/2), all
//   below L1/2, as transforms u of its tile, and their mirrors L1 - k1 as
//   transforms R/2 + u (block 0 holds row L1/2 in the place of row 0's
//   mirror): every row once, and each pair (k, m-k) in one block. It loads
//   the R rows as pass 2 does and runs the forward length-L2 FFT with its
//   spectrum left in the exchange planes (sandwich.cuh
//   `forward_in_place`); then each thread unpacks kP/2 pairs from its own
//   planes (unpack_pair, hermitian.cuh), in groups of 4 consecutive k2 of
//   one row (a warp on 128 consecutive k2), with w = W_n^k = W_n^{k1} *
//   W_{2*L2}^{k2} (one value a row times a table of L2, float64-built and
//   rounded to float32).
//   A block alone owns runs of R/2 consecutive k1 of each k2: stored
//   straight, its bins took 0.38 ms at 16 x 2^20 (R = 8) on an H100, where
//   the same kernel storing 32 consecutive floats a warp took 0.11. So the
//   blocks of 32 consecutive low rows (C = 64/R blocks, R = 8 or 16) make a
//   thread block cluster. Each block sends its outputs into the shared
//   memory of the block that stores their k2 (distributed shared memory)
//   with 16-byte asynchronous stores (st.async), 4 consecutive k2 of a
//   plane each (the mirrors of a group are 4 consecutive k2 too, stored
//   reversed): the X[k] at once, into a staging area past that block's
//   planes, and the X[m-k], after a cluster barrier split around the
//   block's last read of its planes (every block's planes read), in the
//   place of its planes. The stores into each staging area complete on a
//   transaction barrier (mbarrier) of the receiving block, armed at entry
//   for the bytes of every bin of that area, so a block waits for its own
//   bins and for no peer, and stores its low bins while the cluster still
//   reads its planes. No block writes into a peer before every block of
//   the cluster has started: each arrives on the cluster barrier at its
//   entry, after arming its transaction barriers, and waits on it after
//   its row FFTs, which hide the wait. Each block stores the bins of its
//   L2/C elements k2, a thread reading 4 consecutive k2 of one row v, a
//   warp storing 32 consecutive k1 of one k2 (descending for m - k). The
//   Nyquist bin X[m] goes out at once from the thread of k = 0. At 16 x
//   2^20 on an H100 (R = 8) the kernel takes 0.160 ms: the exchange 0.018
//   over a copy with none (DSMEM traffic 0.001, the cluster barrier
//   0.002), the stores 0.038, which overlap no loads (PERF.md §6).
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
// pass's 16). The staged table S would cost 8*(U + F1/U)/F1 bytes a point,
// 1.5 at F1 = 128 and 1 at 256: on an H100 pass A read 2-7% slower with it
// at 2^22..2^26, and the two-pass pass 1 at L1 = 128 3.6%.
//
// Bound on this card: device memory. Each pass reads and writes the
// signal once (16 bytes per point per pass, 268 MB at 16 x 2^20 or at
// 1 x 2^24), against about 5 n log2 n flops. Design: the register engine
// of fft_reg.cuh. The first radix-16 pass loads straight from device
// memory into registers (pass 1: W-float runs of 2^g = 8 neighbouring
// columns per row; pass 2: 32 consecutive floats of one row per warp),
// the passes exchange through padded shared-memory planes (2 exchanges
// at L = 512..2048, 1 at 128..256), and the last pass stores straight
// from registers: pass 1 with the cross twiddle, pass 2 with the scale,
// the corner turn (runs of 8 consecutive k1 per k2) or the interleave;
// pass 2's unpack mode stores from its epilogue.
// The sandwich mode reads and writes the signal once too, and H (8 bytes
// a point of one batch row, L2-resident across batch rows) once a batch
// row. The geometry (W or R, threads, shared bytes, schedule) comes from
// the Python wrappers; with 8K-value tiles two blocks share an SM, so one
// block's loads overlap the other's passes. At 2^20 the intermediate of
// a few rows fits the 50 MB L2; keeping it there on purpose (and a
// blocked intermediate layout) is later work.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "hermitian.cuh"
#include "sandwich.cuh"

using namespace fftlab;

// The thread block cluster of pass 2's unpack mode (sm_90): a barrier of
// all its threads split in two, an arrival (release: this thread's
// shared-memory accesses before it) and the wait for every thread's
// arrival (acquire: every arrived thread's accesses come before what
// follows), with work between (cooperative_groups). A block may touch a
// peer's shared memory only once every block of the cluster has started,
// which a barrier passed by all of them shows.
__device__ __forceinline__ void cluster_arrive() {
  cooperative_groups::this_cluster().barrier_arrive();
}

__device__ __forceinline__ void cluster_wait() { cooperative_groups::this_cluster().barrier_wait(); }

// The shared::cluster address of p's place in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}

// An asynchronous store of 16 bytes (4 floats, `at` 16-byte aligned) or 4
// into the shared memory of a block of the cluster (st.async), whose bytes
// complete on the transaction barrier at `bar` in the same block
// (cluster_addr both). The sender waits for nothing.
__device__ __forceinline__ void store_async(unsigned at, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(at), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_async(unsigned at, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(at), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// A transaction barrier (an mbarrier in this block's shared memory), set
// up by one thread before the cluster's entry barrier, which makes it
// visible to the peers: one arrival, made at once with the bytes that the
// cluster's st.async will bring, so its phase 0 ends when the last byte has
// landed.
__device__ __forceinline__ void arm_barrier(unsigned long long* bar, int bytes) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Waits until phase 0 of a transaction barrier of this block has ended:
// every byte it was armed for has landed, and is visible to this thread.
__device__ __forceinline__ void wait_barrier(unsigned long long* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// Pass 2's unpack mode: a cluster holds 2^kLogUnpackRun consecutive rows
// k1 below L1/2 (and their mirrors), so a warp stores 32 consecutive bins
// (kernels/fourstep_vmem.py UNPACK_RUN). At R = 2^log_r rows a block, a
// cluster is 2^unpack_log_cluster(log_r) blocks, and each of them stores
// L2/C elements k2 from staging areas of rows of unpack_pitch floats (S =
// L2/C + 4: every row starts on 16 bytes, and 8 rows of one k2 lie in 8
// distinct groups of 4 banks; fourstep_vmem.unpack_pitch). Each block
// has a transaction barrier for each staging area, and arms it for
// unpack_tx_bytes: kUnpackBinBytes, a re and an im float, for each bin (v,
// k2) of the area (fourstep_vmem.UNPACK_BIN_BYTES, unpack_tx_bytes).
constexpr int kLogUnpackRun = 5;
constexpr int kUnpackBinBytes = 8;

__host__ __device__ constexpr int unpack_log_cluster(int log_r) {
  return kLogUnpackRun - (log_r - 1);
}

__host__ __device__ constexpr int unpack_pitch(int log_l2, int log_r) {
  return (1 << (log_l2 - unpack_log_cluster(log_r))) + 4;
}

__host__ __device__ constexpr int unpack_tx_bytes(int log_l2, int log_r) {
  return kUnpackBinBytes << (kLogUnpackRun + log_l2 - unpack_log_cluster(log_r));
}

// One pad float every 16, and a row stride of L + L/16 + 4: the tiles'
// exchanges (fft_reg.cuh).
constexpr int kLogPadTiles = 4;

// The rank-1 twiddle tables are built at a width of 16 columns
// (kernels/fourstep_vmem.py PASS1_WIDTH): A is (L2/16, L1), P is (L1, 16).
constexpr int kLogTableWidth = 4;

// Pass 1's staged twiddle (`column_tile`), from L1 = 2^kLogStagedMin
// (kernels/fourstep_vmem.py STAGED_MIN_L1): W_n^{k1*j2} = S[k1 mod U, j2] *
// S[U + k1 div U, j2], U = 2^staged_log_u, S of staged_rows(log_l1) rows
// (kernels/fourstep_vmem.py `_staged_twiddle_np`). U near sqrt(L1) keeps a
// block's share of S, W*(U + L1/U) values, at its least. From there P
// (L1 x 16 float2, 64 KB at 512) no longer stays in L1 beside the planes,
// and the store's loads of A and P from L2 cost 8-11% of the pass on an
// H100; below it P stays, and S would bring a block more table than A's
// row does.
constexpr int kLogStagedMin = 9;

__host__ __device__ constexpr int staged_log_u(int log_l1) { return (log_l1 + 1) >> 1; }

__host__ __device__ constexpr int staged_rows(int log_l1) {
  return (1 << staged_log_u(log_l1)) + (1 << (log_l1 - staged_log_u(log_l1)));
}

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
// columns of one batch row. The twiddled modes (all but kNoTwiddle) at
// L1 >= 2^kLogStagedMin stage the block's W columns of S (`staged_rows`)
// in shared memory past the exchange planes, row q's column t at q*W +
// (t ^ ((q << g) & (W - 1))): every load is issued beside the first
// pass's, and the store multiplies by two shared-memory reads. The last
// pass gives a warp 32/2^g neighbouring k1 of 2^g neighbouring columns,
// so its reads of the first factor are 256 contiguous bytes (at W = 16
// the XOR puts odd rows' halves on the other 16 banks) and of the second
// one row's 2^g values. At shorter L1 the store reads A[j2/16, k1] *
// P[k1, j2 mod 16] itself.
template <int kMode, int kLogL1>
__device__ __forceinline__ void column_tile(const float* __restrict__ xr,
                                            const float* __restrict__ xi, float* __restrict__ mr,
                                            float* __restrict__ mi,
                                            const float2* __restrict__ tw1,
                                            const float2* __restrict__ a_tab,
                                            const float2* __restrict__ p_tab,
                                            const float2* __restrict__ s_tab, int log_l2,
                                            int log_w, int log_f1, const Geometry& geo,
                                            float sign) {
  constexpr int log_l1 = kLogL1;
  constexpr bool kStaged = kMode != kNoTwiddle && kLogL1 >= kLogStagedMin;
  constexpr int log_u = staged_log_u(kLogL1);
  constexpr int kRows = staged_rows(kLogL1);
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
  const int g = run_bits(log_w);
  const Engine<kLogL1, kLogPadTiles> engine{make_tile(log_w, geo), g, g, sign};
  // W_n^{k1*j2} = A[j2 / 16, k1] * P[k1, j2 mod 16] below 2^kLogStagedMin
  const float2* __restrict__ a_c = a_tab + (static_cast<size_t>(j2_0 >> kLogTableWidth) << log_l1);
  const float2* __restrict__ p_c = p_tab + (j2_0 & ((1 << kLogTableWidth) - 1));
  // the staged columns of S, past the planes' 2*W*stride floats
  float2* const staged = smem_tile() + (geo.stride << log_w);
  const int swizzle = (1 << log_w) - 1;
  const auto staged_at = [&](int q, int t) { return (q << log_w) + (t ^ ((q << g) & swizzle)); };
  const auto load = [&](int t, int j1) {
    const int at = (j1 << log_l2) + t;
    if constexpr (kMode == kPackedReal) {
      return __ldg(reinterpret_cast<const float2*>(xr) + col0 + at);
    } else {
      return make_float2(__ldg(xr + col0 + at), __ldg(xi + col0 + at));
    }
  };
  const auto store = [&](int t, int k1, float2 y) {
    if constexpr (kStaged) {
      y = cmul(y, cmul(staged[staged_at(k1 & ((1 << log_u) - 1), t)],
                       staged[staged_at((1 << log_u) + (k1 >> log_u), t)]));
    } else if constexpr (kMode != kNoTwiddle) {
      y = cmul(y, cmul(__ldg(a_c + k1), __ldg(p_c + (k1 << kLogTableWidth) + t)));
    }
    const int at = (k1 << log_out_row) + t;
    outr[at] = y.x;
    outi[at] = y.y;
  };
  // S's rows by pairs of columns: one 16-byte load and store each
  engine.run(tw1, 1.0f, load, store, [&] {
    if constexpr (kStaged) {
      for (int i = threadIdx.x; i < kRows << (log_w - 1); i += blockDim.x) {
        const int q = i >> (log_w - 1);
        const int t = (i << 1) & swizzle;
        *reinterpret_cast<float4*>(staged + staged_at(q, t)) = __ldg(
            reinterpret_cast<const float4*>(s_tab + (static_cast<size_t>(q) << log_l2) + j2_0 + t));
      }
    }
  });
}

template <int kMode, int kLogL1>
__global__ void __launch_bounds__(pass1_threads<kMode, kLogL1>(),
                                  blocks_per_sm<pass1_threads<kMode, kLogL1>()>())
fourstep_pass1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ mr, float* __restrict__ mi,
                      const float2* __restrict__ tw1, const float2* __restrict__ a_tab,
                      const float2* __restrict__ p_tab, const float2* __restrict__ s_tab,
                      int log_l2, int log_w, int log_f1, Geometry geo, float sign, long long rows,
                      int log_g) {
  if constexpr (kMode == kStage) {
    stage_tile<kLogL1>(xr, xi, mr, mi, tw1, a_tab, p_tab, log_l2, log_f1, geo, sign, rows, log_g);
  } else {
    column_tile<kMode, kLogL1>(xr, xi, mr, mi, tw1, a_tab, p_tab, s_tab, log_l2, log_w, log_f1,
                               geo, sign);
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

// Pass 2's unpack mode (the comment at the top of this file): block
// b*(L1/R) + c of the (batch, L1, L2) intermediate m, rows c*R/2 + u and
// their mirrors, into bins 0..M of the one-sided planes x ([batch, M + 1],
// M = L1*L2), in clusters of 2^kLogUnpackRun/(R/2) blocks; shared memory:
// the exchange planes, the low staging area, then the transaction barriers
// of the low and of the high area (`fftlab_fourstep_pass2_unpack`). tw2:
// the engine's forward twiddle table of L2; utw: W_{2*L2}^{k2} for k2 < L2,
// then W_{2M}^{k1} for k1 <= L1/2 (16-byte aligned); h: half the output
// scale.
template <int kLogL2>
__global__ void __launch_bounds__(tile_threads<kLogL2>(), blocks_per_sm<tile_threads<kLogL2>()>())
fourstep_pass2_unpack_kernel(const float* __restrict__ mr, const float* __restrict__ mi,
                             float* __restrict__ xr, float* __restrict__ xi,
                             const float2* __restrict__ tw2, const float2* __restrict__ utw,
                             int log_l1, int log_r, Geometry geo, float h) {
  constexpr int log_l2 = kLogL2;
  constexpr int L2 = 1 << kLogL2;
  const int log_u = log_r - 1;  // R/2 = 2^log_u rows below L1/2, and their mirrors
  const int half = 1 << log_u;
  const int log_g = log_l1 - log_r;
  const int l1 = 1 << log_l1;
  const int m = l1 << log_l2;
  const int c = blockIdx.x & ((1 << log_g) - 1);
  const int k1_0 = c << log_u;
  // 64-bit block bases, 32-bit offsets inside a row of L1*L2 <= 2^26
  const size_t b = blockIdx.x >> log_g;
  const size_t in0 = b << (log_l1 + log_l2);
  float* __restrict__ yr = xr + b * (m + 1);
  float* __restrict__ yi = xi + b * (m + 1);
  const Tile x = make_tile(log_r, geo);
  // The cluster's 2^kLogUnpackRun low rows k1 = k1_c + v (block v / (R/2)
  // of the cluster holds row v as transform v mod R/2) and their mirrors;
  // block `rank` of the cluster stores the bins of elements k2_r .. k2_r +
  // L2/C - 1 of them from two staging areas, each a re and an im plane of
  // 32 rows v of S floats (bin (v, k2) at v*S + k2 - k2_r): the low bins
  // X[k2*L1 + k1_c + v] past the exchange planes, sent as soon as they are
  // computed, and the high bins X[k2*L1 + L1 - k1_c - v] (of row L1/2 for
  // v = 0 in the first cluster) in the place of the planes, once every
  // block of the cluster has read its own. Every bin of both areas comes
  // once, by st.async, and a transaction barrier of the block past the low
  // area counts the bytes of each area: the block stores its low bins
  // while the cluster still reads its planes, then its high bins.
  const int log_c = unpack_log_cluster(log_r);  // blocks a cluster
  const int log_kr = log_l2 - log_c;            // elements k2 a block stores
  const int stage = unpack_pitch(log_l2, log_r);  // S
  const int plane = stage << kLogUnpackRun;       // a staging area's re plane to its im
  const int rank = c & ((1 << log_c) - 1);
  const int k1_c = (c >> log_c) << kLogUnpackRun;
  float* const high = x.re;
  float* const low = x.re + ((2 * geo.stride) << log_r);
  unsigned long long* const bar = reinterpret_cast<unsigned long long*>(low + 2 * plane);
  // The epilogue writes into the peers' staging areas; the row FFTs hide
  // the wait for every block of the cluster to have started, and the
  // entry barrier makes this block's transaction barriers visible to them.
  if (threadIdx.x == 0) {
    arm_barrier(bar, unpack_tx_bytes(log_l2, log_r));      // the low area's
    arm_barrier(bar + 1, unpack_tx_bytes(log_l2, log_r));  // the high area's
  }
  cluster_arrive();
  // R whole rows: a warp reads 32 consecutive floats of one row
  const int z = forward_in_place<kLogL2, kLogPadTiles>(x, tw2, run_bits(log_r), [&](int t, int e) {
    const int lo = k1_0 + (t & (half - 1));
    const int k1 = t < half ? lo : (lo == 0 ? l1 >> 1 : l1 - lo);
    const int at = (k1 << log_l2) + e;
    return make_float2(__ldg(mr + in0 + at), __ldg(mi + in0 + at));
  });
  // The 4 pairs of a group: X[k] and X[m-k] from Z[k] (elements k2 + r of
  // transform t_lo, row k1; k2 a multiple of 4) and Z[m-k] (elements
  // (e_hi - r) mod L2 of transform t_hi), r < 4
  const auto group = [&](UnpackPair (&o)[4], int t_lo, int k2, int k1, int t_hi, int e_hi) {
    const float2 w1 = __ldg(utw + L2 + k1);
    const float4 wa = __ldg(reinterpret_cast<const float4*>(utw + k2));
    const float4 wb = __ldg(reinterpret_cast<const float4*>(utw + k2) + 1);
    const float2 w2[4] = {make_float2(wa.x, wa.y), make_float2(wa.z, wa.w),
                          make_float2(wb.x, wb.y), make_float2(wb.z, wb.w)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = padded<kLogPadTiles>(x, t_lo, k2 + r);
      const int d = padded<kLogPadTiles>(x, t_hi, (e_hi - r) & (L2 - 1));
      o[r] = unpack_pair(make_float2(x.re[a], x.im[a]), make_float2(x.re[d], x.im[d]),
                         cmul(w1, w2[r]), h);
    }
  };
  // bin (v, k2) of the staging area `area` (low or high) of the block that
  // stores k2, and that block's transaction barrier of the area (x, y)
  const auto target = [&](float* area, int v, int k2) {
    const int to = k2 >> log_kr;
    return make_uint2(cluster_addr(area + v * stage + (k2 & ((1 << log_kr) - 1)), to),
                      cluster_addr(area == low ? bar : bar + 1, to));
  };
  // bins (v, k2 .. k2 + 3) (k2 a multiple of 4), a float4 of re and of im;
  // `rev`: val[3 - r] at k2 + r
  const auto put4 = [&](float* area, int v, int k2, const float2* val, bool rev) {
    const uint2 at = target(area, v, k2);
    const int i = rev ? 3 : 0, d = rev ? -1 : 1;
    store_async(at.x, make_float4(val[i].x, val[i + d].x, val[i + 2 * d].x, val[i + 3 * d].x),
                at.y);
    store_async(at.x + 4 * plane,
                make_float4(val[i].y, val[i + d].y, val[i + 2 * d].y, val[i + 3 * d].y), at.y);
  };
  // bin (v, k2) alone
  const auto put1 = [&](float* area, int v, int k2, float2 val) {
    const uint2 at = target(area, v, k2);
    store_async(at.x, val.x, at.y);
    store_async(at.x + 4 * plane, val.y, at.y);
  };
  // Group j of this thread: pairs p = 4*(s + j*threads) + r, row u = p / L2
  // (transform u, k1 = k1_0 + u, cluster row v = rank*R/2 + u), elements
  // k2 = p mod L2 (a multiple of 4) + r, so a warp holds 128 consecutive k2
  // of one row: X[k] is low bin (v, k2 + r), X[m-k] high bin (v, L2-1-k2-r),
  // and each goes as one float4 a plane, the high one reversed. In block 0
  // row 0 pairs k2 with L2 - k2 (low bins (0, k2) and (0, L2 - k2), the
  // latter a float at a time; X[0] with the Nyquist bin, which goes out at
  // once) and row L1/2 (transform R/2) k2' = k2 - L2/2 with L2-1-k2' (high
  // bins of v = 0).
  const int s = threadIdx.x + z;
  const auto p_of = [&](int j) { return (s + j * blockDim.x) << 2; };
  float2 hi_val[kP / 2];  // group j's X[m-k] at 4j + r
  float2 row_half[4];     // block 0: row L1/2's X[k] (at most one group a thread)
  cluster_wait();         // every block of the cluster has started
#pragma unroll
  for (int j = 0; j < kP / 8; ++j) {
    const int u = p_of(j) >> log_l2, k2 = p_of(j) & (L2 - 1);
    UnpackPair o[4];
    float2 lo[4];
    if (k1_0 + u != 0) {
      group(o, u, k2, k1_0 + u, half + u, L2 - 1 - k2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[r] = o[r].low;
        hi_val[4 * j + r] = o[r].high;
      }
      put4(low, (rank << log_u) + u, k2, lo, false);
    } else if (k2 < L2 / 2) {
      group(o, 0, k2, 0, 0, L2 - k2);
#pragma unroll
      for (int r = 0; r < 4; ++r) lo[r] = o[r].low;
      put4(low, 0, k2, lo, false);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k2 + r == 0) {
          yr[m] = o[r].high.x;
          yi[m] = o[r].high.y;
        } else {
          put1(low, 0, L2 - k2 - r, o[r].high);
        }
      }
    } else {
      group(o, half, k2 - L2 / 2, l1 >> 1, half, L2 - 1 - (k2 - L2 / 2));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        row_half[r] = o[r].low;
        hi_val[4 * j + r] = o[r].high;
      }
    }
  }
  if (k1_0 == 0 && s == 0) {  // bin m/2: row 0's element L2/2, its own mirror
    const int a = padded<kLogPadTiles>(x, 0, L2 / 2);
    const float2 zm = make_float2(x.re[a], x.im[a]);
    put1(low, 0, L2 / 2, unpack_pair(zm, zm, cmul(__ldg(utw + L2), __ldg(utw + L2 / 2)), h).low);
  }
  // bins (v, k2 .. k2 + 3) of a staging area: thread s takes v = s mod 32
  // and reads 16 bytes of a plane, so a warp stores 32 consecutive k1 of one
  // k2 at a time, row k1 for bin v
  const int v = s & ((1 << kLogUnpackRun) - 1);
  const auto out4 = [&](float* y, int at, float4 val) {
    y[at] = val.x;
    y[at + l1] = val.y;
    y[at + 2 * l1] = val.z;
    y[at + 3 * l1] = val.w;
  };
  const auto store = [&](const float* area, int k1) {
    for (int i = (s >> kLogUnpackRun) << 2; i < 1 << log_kr;
         i += (blockDim.x >> kLogUnpackRun) << 2) {
      const int at = ((rank << log_kr) + i) * l1 + k1;
      out4(yr, at, *reinterpret_cast<const float4*>(area + v * stage + i));
      out4(yi, at, *reinterpret_cast<const float4*>(area + v * stage + i + plane));
    }
  };
  cluster_arrive();   // this block's planes read
  wait_barrier(bar);  // every low bin of this block's elements staged
  store(low, k1_c + v);
  cluster_wait();  // every block's planes read: the high staging areas are free
#pragma unroll
  for (int j = 0; j < kP / 8; ++j) {
    const int u = p_of(j) >> log_l2, k2 = p_of(j) & (L2 - 1);
    if (k1_0 + u != 0) {
      put4(high, (rank << log_u) + u, L2 - 4 - k2, hi_val + 4 * j, true);
    } else if (k2 >= L2 / 2) {
      put4(high, 0, k2 - L2 / 2, row_half, false);
      put4(high, 0, L2 - 4 - (k2 - L2 / 2), hi_val + 4 * j, true);
    }
  }
  wait_barrier(bar + 1);  // every high bin staged
  store(high, (k1_c == 0 && v == 0) ? l1 >> 1 : l1 - k1_c - v);  // descending k1
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

// `launch` in clusters of `cluster` consecutive blocks.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), long long grid, int cluster,
                           const Geometry& geo, void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(geo.threads);
  config.dynamicSmemBytes = geo.smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

// batch: rows of L1*L2 the kernel transforms (for kSwapStore, F1 times
// the caller's batch). A twiddled mode takes A and P below
// 2^kLogStagedMin, else S, and then its shared memory holds the planes and
// the block's staged_rows x W values of S.
template <int kMode>
int launch_pass1(const float* xr, const float* xi, float* mr, float* mi, const void* tw1,
                 const void* a_tab, const void* p_tab, const void* s_tab, long long batch,
                 int log_l1, int log_l2, int log_w, int log_f1, Geometry geo, int direction,
                 void* stream) {
  const bool staged = kMode != kNoTwiddle && log_l1 >= kLogStagedMin;
  const long long blocks = batch << (log_l2 - log_w);
  if (!valid_geometry(geo, log_l1, log_w, kLogPadTiles) || log_w > kLogTableWidth ||
      log_w < 2 || log_l2 < kLogTableWidth || log_l2 > 26 || batch < 1 || blocks > INT_MAX ||
      log_f1 < 0 || (batch & ((1LL << log_f1) - 1)) != 0 ||
      (direction != 1 && direction != -1) ||
      (staged &&
       (s_tab == nullptr || geo.smem < ((8LL * (geo.stride + staged_rows(log_l1))) << log_w))) ||
      (kMode != kNoTwiddle && !staged && (a_tab == nullptr || p_tab == nullptr))) {
    return cudaErrorInvalidValue;
  }
  return dispatch<7, 10>(log_l1, [&](auto log_l1_c) {
    return launch(fourstep_pass1_kernel<kMode, decltype(log_l1_c)::value>, blocks, geo, stream,
                  xr, xi, mr, mi, static_cast<const float2*>(tw1),
                  static_cast<const float2*>(a_tab), static_cast<const float2*>(p_tab),
                  static_cast<const float2*>(s_tab), log_l2, log_w, log_f1, geo,
                  static_cast<float>(direction), batch, 0);
  });
}

}  // namespace

// Pass 1. x: [batch, L1*L2] float32 planes; m: the (batch, L1, L2)
// intermediate planes; tw1: the engine's twiddle table for L1; W_n^{k1*j2}
// below L1 = 2^kLogStagedMin as a_tab: (L2/16, L1) and p_tab: (L1, 16)
// float2 rank-1 factors, from it as s_tab: the (staged_rows(log_l1), L2)
// float2 table S (`column_tile`; the other tables may be null); W =
// 2^log_w <= 16 columns per block; geo: the launch geometry of
// kernels/fourstep_vmem.py `pass1_geometry`. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1(const float* xr, const float* xi, float* mr, float* mi,
                                     const void* tw1, const void* a_tab, const void* p_tab,
                                     const void* s_tab, long long batch, int log_l1,
                                     int log_l2, int log_w, Geometry geo, int direction,
                                     void* stream) {
  return launch_pass1<kPlainLoad>(xr, xi, mr, mi, tw1, a_tab, p_tab, s_tab, batch, log_l1,
                                  log_l2, log_w, 0, geo, direction, stream);
}

// Pass 1 with no twiddle (kNoTwiddle): the column FFTs alone, stored at
// k1*L2 + j2. Planes, tw1 and the rest as fftlab_fourstep_pass1. Returns
// a cudaError_t.
extern "C" int fftlab_fourstep_pass1_no_twiddle(const float* xr, const float* xi, float* mr,
                                                float* mi, const void* tw1, long long batch,
                                                int log_l1, int log_l2, int log_w, Geometry geo,
                                                int direction, void* stream) {
  return launch_pass1<kNoTwiddle>(xr, xi, mr, mi, tw1, nullptr, nullptr, nullptr, batch, log_l1,
                                  log_l2, log_w, 0, geo, direction, stream);
}

// Pass 1 of a packed real signal. x: [batch, 2*L1*L2] float32 (8-byte
// aligned), complex element j = (x[2j], x[2j+1]); the rest as
// fftlab_fourstep_pass1. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1_packed(const float* x, float* mr, float* mi,
                                            const void* tw1, const void* a_tab,
                                            const void* p_tab, const void* s_tab,
                                            long long batch, int log_l1, int log_l2, int log_w,
                                            Geometry geo, int direction, void* stream) {
  return launch_pass1<kPackedReal>(x, nullptr, mr, mi, tw1, a_tab, p_tab, s_tab, batch, log_l1,
                                   log_l2, log_w, 0, geo, direction, stream);
}

// Pass B of the three-pass FFT: pass 1 of batch*F1 rows of L1*L2 (row
// bb = o*F1 + k1a), its output row k1 stored at row (o, k1, k1a) of the
// (batch, L1, F1) row grid, F1 = 2^log_f1: the (k1a, k1) axes swap on the
// store. Planes and tables as fftlab_fourstep_pass1. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass1_swap(const float* xr, const float* xi, float* mr, float* mi,
                                          const void* tw1, const void* a_tab, const void* p_tab,
                                          const void* s_tab, long long batch, int log_f1,
                                          int log_l1, int log_l2, int log_w, Geometry geo,
                                          int direction, void* stream) {
  if (batch < 1 || log_f1 < 0 || log_f1 > 20) return cudaErrorInvalidValue;
  return launch_pass1<kSwapStore>(xr, xi, mr, mi, tw1, a_tab, p_tab, s_tab, batch << log_f1,
                                  log_l1, log_l2, log_w, log_f1, geo, direction, stream);
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

// Pass 2's unpack mode, the fused r2c's last launch (forward only). m: the
// (batch, L1, L2) intermediate planes of the packed pass 1; x: [batch,
// L1*L2 + 1] one-sided output planes, bins 0..L1*L2, times `scale`; tw2:
// the engine's forward twiddle table for L2; utw: L2 + L1/2 + 1 float2,
// W_{2*L2}^{k2} (k2 < L2), then W_n^{k1} (k1 <= L1/2, n = 2*L1*L2), 16-byte
// aligned; R = 2^log_r rows per block, 8 or 16, in clusters of 64/R
// blocks (L1 >= 64); geo: the launch geometry of kernels/fourstep_vmem.py
// `pass2_unpack_geometry`, its shared memory the planes, the low staging
// area and the two transaction barriers. Returns a cudaError_t.
extern "C" int fftlab_fourstep_pass2_unpack(const float* mr, const float* mi, float* xr,
                                            float* xi, const void* tw2, const void* utw,
                                            long long batch, int log_l1, int log_l2, int log_r,
                                            Geometry geo, float scale, void* stream) {
  const long long blocks = batch << (log_l1 - log_r);
  if (utw == nullptr || reinterpret_cast<uintptr_t>(utw) % 16 != 0 ||
      !valid_geometry(geo, log_l2, log_r, kLogPadTiles) || geo.stride % 4 != 0 || log_r < 3 ||
      log_l1 < kLogUnpackRun + 1 || log_l1 + log_l2 > 26 || batch < 1 || blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  // the low staging area past the planes (2 planes of 2^kLogUnpackRun
  // rows), then the two 8-byte transaction barriers
  const long long low_area = (8LL * unpack_pitch(log_l2, log_r)) << kLogUnpackRun;
  if (geo.smem < ((8LL * geo.stride) << log_r) + low_area + 16) return cudaErrorInvalidValue;
  return dispatch<8, 10>(log_l2, [&](auto log_l2_c) {
    return launch_cluster(fourstep_pass2_unpack_kernel<decltype(log_l2_c)::value>, blocks,
                          1 << unpack_log_cluster(log_r), geo, stream, mr, mi, xr, xi,
                          static_cast<const float2*>(tw2), static_cast<const float2*>(utw),
                          log_l1, log_r, geo, 0.5f * scale);
  });
}

// One stage of the stage pipeline: pass 1 in kStage mode (`stage_tile`).
// x: [rows, L1*L2] float32 planes, L1 = 2^log_l1 in 2..128, L2 =
// 2^log_l2 >= 16; y: the same shape, output row k1 of input row
// o*F1 + k1a stored at row (o, k1, k1a), F1 = 2^log_f1 dividing rows
// (F1 = 1: the plain pass-1 store); tw1: the engine's twiddle table for
// L1; a_tab (L2/16, L1) and p_tab (L1, 16): W_n^{k1*j2} in rank-1 form
// (A and P of ones: no twiddle); G = 2^log_g rows
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
                  static_cast<const float2*>(a_tab), static_cast<const float2*>(p_tab), nullptr,
                  log_l2, kLogTableWidth, log_f1, geo, static_cast<float>(direction), rows,
                  log_g);
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
