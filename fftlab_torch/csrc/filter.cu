// filter_rows / os_filter: the FFT -> H -> IFFT sandwich of transforms of
// L = 2^log_l points, 512 <= L <= 16384, on the register engine of
// fft_reg.cuh.
//
// filter_rows replaces the TPU kernel fftlab/kernels/fft_vmem.py
//   `_pallas_filter_impl` (`_filter_kernel`: `_fwd_body`, times H,
//   `_inv_body`, one row per program in VMEM). The TPU kernel takes H as
//   H.reshape(128, m) to match its transposed forward output; the engine
//   is in natural order, so H is read in natural order.
// os_filter replaces fftlab/kernels/os_filter_vmem.py `_os_filter_impl`
//   and `_os_filter_aligned_impl` (`_os_kernel`, `_os_aligned_kernel`):
//   a causal FIR by overlap-save. Frame f of channel c holds samples
//   f*hop - halo .. f*hop - halo + L - 1 (zero below 0 and past the end,
//   so the signal needs no padded copy); its outputs halo..L-1 are the
//   filter's outputs f*hop .. f*hop + hop - 1. halo = taps - 1 exactly;
//   the TPU kernels round it up to whole 128-lane rows for their DMA
//   layout.
//
// Bound on this card: device memory. The sandwich reads and writes each
// point once (16 bytes in split float32) against about 10 log2 L flops
// per point, under 9 flops per byte at 16K. Design:
//   - one sandwich (`sandwich`): the engine's forward transform leaves the
//     spectrum in the exchange planes (`forward_in_place`); the inverse's first
//     pass reads it there times H (`__ldg`, natural order, L2-resident
//     across blocks), and its last pass stores with 1/L folded in. Nothing
//     leaves the SM between the two transforms, and a 16K row crosses the
//     planes 7 times (3 exchanges, the in-place hand-off, 3 exchanges),
//     a 1K frame 5 times, where radix-4 stages in shared memory took 14
//     and 10;
//   - filter_rows: one row per block, swizzled (fft_rows' geometry): the
//     first pass loads from the row, the last stores to it;
//   - os_filter: block (c, g) takes the T consecutive frames f0 = g*T ..
//     f0+T-1 of channel c, T = 4096/L up to 2K frames (the most 8192/L)
//     and 1 from 4K. The forward's first pass reads frame t's element e
//     straight from the signal, x[(f0+t)*hop - halo + e] (zero outside
//     [0, n)), neighbouring threads on neighbouring samples, all 32 loads
//     of a thread issued before its first butterfly; the halo a frame
//     shares with the one before comes from L2. (A span of the T frames
//     read once into shared memory with cp.async lost 4-7% to this in
//     turns.) The frames are stacked swizzled rows of the planes
//     (`kFrameRows`; one swizzled row from 4K) and every pass puts
//     neighbouring threads on neighbouring elements of one frame (slot
//     mapping 0), so every exchange takes one wavefront per 32 floats
//     (tests/test_torch_geometry.py), and the inverse's last pass stores
//     outputs e >= halo of frame t straight to y[(f0+t)*hop + e - halo]:
//     a warp's stores are 32 consecutive floats, and a block's T*hop
//     outputs are one contiguous run per plane.

#include <climits>

#include "fft_reg.cuh"

using namespace fftlab;

// The forward transform of every transform of the tile x (first-pass
// inputs through `load(t, e)`) with its outputs left in the planes, in
// natural order: the passes of Engine::run_in_place. Its last pass reads
// all of its inputs into registers before a barrier and writes its
// outputs in place after it; the slots of those writes are rebuilt after
// the barrier from z, the barrier's result (0), which the compiler cannot
// see through: otherwise it keeps the reads' plane addresses live across
// the barrier and spills at 4 and 8 slots a thread (ptxas, sm_90a).
// Returns z, the 0 of the closing barrier, for the same use. (The same
// change in Engine::run_in_place cost stft_frames 2.6% at 4096/1024.)
template <int kLogL, int kLogPad, class Load>
__device__ __forceinline__ int forward_in_place(const Tile& x, const float2* __restrict__ tw,
                                                Load load) {
  using Fwd = Engine<kLogL, kLogPad>;
  constexpr int R = Fwd::kLastR;
  constexpr int kLogJ = kLogL - (Fwd::kLogLast == 0 ? 4 : Fwd::kLogLast);  // ns = L/R
  const Fwd fwd{x, 0, 0, -1.0f};
  float2 v[kP];
  fwd.load_first(v, load);
  dft<16>(v, 0, -1.0f);
  int log_ns = 0;
#pragma unroll
  for (int p = 0; p < Fwd::kMid; ++p) {
    fwd.exchange16(v, log_ns, 0, tw);
    tw += 16 << (log_ns + 4);
    log_ns += 4;
  }
  fwd.write16(v, log_ns, 0);
#pragma unroll
  for (int i = 0; i < kP / R; ++i) {
    int j, t;
    slot_of(i, 0, kLogJ, j, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int at = padded<kLogPad>(x, t, j + (r << kLogJ));
      v[i * R + r] = make_float2(x.re[at], x.im[at]);
    }
    twiddle<R>(v, i * R, tw, j, 1 << kLogJ);
    dft<R>(v, i * R, -1.0f);
  }
  const int z = __syncthreads_or(0);
#pragma unroll
  for (int i = 0; i < kP / R; ++i) {
    int j, t;
    slot_of(i, z, kLogJ, j, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int at = padded<kLogPad>(x, t, j + (r << kLogJ));
      x.re[at] = v[i * R + r].x;
      x.im[at] = v[i * R + r].y;
    }
  }
  return __syncthreads_or(0);
}

// The forward transform of every transform of the tile x (first-pass
// inputs through `load(t, e)`), times H, the inverse with `scale`, its
// outputs through the functor `make_store(z)` returns (`store(t, e,
// value)`); tw_fwd, tw_inv: the engine's twiddle tables of L for each
// direction. Both transforms put neighbouring threads on neighbouring
// elements (slot mapping 0); for the inverse that 0 is z, the result of
// forward_in_place's closing barrier, which the compiler cannot see through,
// so it does not keep the forward's plane addresses (the same slots) live
// for the inverse (300-1200 bytes of spills without it). make_store
// builds the store's pointers from z too, after the hand-off, for the
// same reason.
template <int kLogL, int kLogPad, class Load, class MakeStore>
__device__ __forceinline__ void sandwich(const Tile& x, const float2* __restrict__ tw_fwd,
                                         const float2* __restrict__ tw_inv,
                                         const float* __restrict__ hr,
                                         const float* __restrict__ hi, float scale, Load load,
                                         MakeStore make_store) {
  const int z = forward_in_place<kLogL, kLogPad>(x, tw_fwd, load);
  const Engine<kLogL, kLogPad> inv{x, z, z, 1.0f};
  inv.run(
      tw_inv, scale,
      [&](int t, int e) {
        const int a = padded<kLogPad>(x, t, e);
        return cmul(make_float2(x.re[a], x.im[a]), make_float2(__ldg(hr + e), __ldg(hi + e)));
      },
      make_store(z));
}

// No pad: a row's exchanges are swizzled (fft_reg.cuh `padded`).
constexpr int kLogPadRows = 0;

template <int kLogN>
__global__ void __launch_bounds__(1 << (kLogN - 4), blocks_per_sm<(1 << (kLogN - 4))>())
filter_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv,
                   const float* __restrict__ hr, const float* __restrict__ hi, Geometry geo,
                   float scale) {
  const size_t base = static_cast<size_t>(blockIdx.x) << kLogN;
  const float* __restrict__ ar = xr + base;
  const float* __restrict__ ai = xi + base;
  sandwich<kLogN, kLogPadRows>(
      make_tile(0, geo), tw_fwd, tw_inv, hr, hi, scale,
      [&](int, int e) { return make_float2(__ldg(ar + e), __ldg(ai + e)); },
      [&](int z) {
        const size_t at = static_cast<size_t>(blockIdx.x + z) << kLogN;
        return [br = yr + at, bi = yi + at](int, int e, float2 y) {
          br[e] = y.x;
          bi[e] = y.y;
        };
      });
}

// Frames of 2^kLogL points from which a block takes one frame, on the
// single swizzled row (L >= 4096), and the most threads of a block below
// (T*L <= 8192).
constexpr int kLogOneFrame = 12;
template <int kLogL>
constexpr int os_threads() {
  return kLogL >= kLogOneFrame ? 1 << (kLogL - 4) : 512;
}

// One block = T = 2^log_t consecutive frames of L = 2^kLogL points of one
// channel: block b is group b % n_groups of channel b / n_groups. x, y:
// [channels, n] planes; geo: kernels/os_filter_vmem.py `os_geometry`
// (stacked swizzled rows, T*L/16 threads; one swizzled row from 4K).
template <int kLogL>
__global__ void __launch_bounds__(os_threads<kLogL>(), blocks_per_sm<os_threads<kLogL>()>())
os_filter_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv,
                 const float* __restrict__ hr, const float* __restrict__ hi, long long n,
                 int hop, int halo, int log_t, int n_groups, Geometry geo, float scale) {
  constexpr bool kOneFrame = kLogL >= kLogOneFrame;
  const size_t row = static_cast<size_t>(blockIdx.x / n_groups) * static_cast<size_t>(n);
  // the block's first output sample, f0*hop, and its first input sample
  const long long out0 = (static_cast<long long>(blockIdx.x % n_groups) << log_t) * hop;
  const long long s0 = out0 - halo;
  // the block's samples s0 + u, u in [lo, hi), inside the row
  const float* __restrict__ ar = xr + row + s0;
  const float* __restrict__ ai = xi + row + s0;
  const long long span = (static_cast<long long>(hop) << log_t) + halo;
  const int lo = s0 < 0 ? static_cast<int>(-s0) : 0;
  const int hi_ = static_cast<int>(n - s0 < span ? n - s0 : span);
  sandwich<kLogL, kOneFrame ? kLogPadRows : kFrameRows>(
      make_tile(log_t, geo), tw_fwd, tw_inv, hr, hi, scale,
      [&](int t, int e) {
        const int u = kOneFrame ? e : t * hop + e;
        return u >= lo && u < hi_ ? make_float2(__ldg(ar + u), __ldg(ai + u))
                                  : make_float2(0.0f, 0.0f);
      },
      [&](int z) {
        const int b = blockIdx.x + z;
        const size_t at = static_cast<size_t>(b / n_groups) * static_cast<size_t>(n);
        const long long o = (static_cast<long long>(b % n_groups) << log_t) * hop;
        // outputs of this block that lie before the row's end
        const long long left = n - o;
        const int run = static_cast<int>(left < (static_cast<long long>(hop) << log_t)
                                             ? left
                                             : static_cast<long long>(hop) << log_t);
        return [br = yr + at + o, bi = yi + at + o, hop, halo, run](int t, int e, float2 y) {
          const int q = t * hop + e - halo;
          if (e >= halo && q < run) {
            br[q] = y.x;
            bi[q] = y.y;
          }
        };
      });
}

// xr, xi, yr, yi: [batch, 2^log_n] float32 on the device; tw_fwd, tw_inv:
// the engine's twiddle tables for n, forward and inverse; hr, hi: the
// n-point response in natural bin order; geo: the launch geometry of
// kernels/fft_vmem.py `rows_geometry`; scale: the output scale (1/n for
// ifft(fft(x)*H)). Returns a cudaError_t.
extern "C" int fftlab_filter_rows(const float* xr, const float* xi, float* yr, float* yi,
                                  const void* tw_fwd, const void* tw_inv, const float* hr,
                                  const float* hi, long long batch, int log_n, Geometry geo,
                                  float scale, void* stream) {
  if (log_n < 9 || !valid_geometry(geo, log_n, 0, kLogPadRows) || batch < 1 ||
      batch > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  return dispatch<9, 14>(log_n, [&](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    cudaError_t err = cudaFuncSetAttribute(
        filter_rows_kernel<kLogN>, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return err;
    filter_rows_kernel<kLogN><<<static_cast<unsigned>(batch), geo.threads, geo.smem,
                                static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, static_cast<const float2*>(tw_fwd), static_cast<const float2*>(tw_inv),
        hr, hi, geo, scale);
    return cudaGetLastError();
  });
}

// Overlap-save FIR. x, y: [channels, n] float32 planes on the device, at
// any float offset; frames of L = 2^log_l points start every hop samples,
// halo = taps - 1 = L - hop samples before the hop they produce; T =
// 2^log_t frames per block, T*L <= 8192, T = 1 at L >= 4096; tw_fwd,
// tw_inv, hr, hi and scale as for fftlab_filter_rows, with hr + i*hi the
// spectrum of the zero-padded taps; geo: kernels/os_filter_vmem.py
// `os_geometry`. Returns a cudaError_t.
extern "C" int fftlab_os_filter(const float* xr, const float* xi, float* yr, float* yi,
                                const void* tw_fwd, const void* tw_inv, const float* hr,
                                const float* hi, long long channels, long long n, int hop,
                                int halo, int log_l, int log_t, Geometry geo, float scale,
                                void* stream) {
  const bool one_frame = log_l >= kLogOneFrame;
  if (log_l < 9 || log_l > 14 || log_t < 0 || log_t > 4 ||
      (one_frame ? log_t != 0 : (1 << log_l << log_t) > 8192) || channels < 1 || n < 1 ||
      halo < 0 || hop < 1 || halo + hop != (1 << log_l) ||
      !valid_geometry(geo, log_l, log_t, one_frame ? kLogPadRows : kFrameRows)) {
    return cudaErrorInvalidValue;
  }
  const long long frames = (n + hop - 1) / hop;
  const long long n_groups = (frames + (1LL << log_t) - 1) >> log_t;
  if (n_groups > INT_MAX || channels * n_groups > INT_MAX) return cudaErrorInvalidValue;
  return dispatch<9, 14>(log_l, [&](auto log_l_c) {
    constexpr int kLogL = decltype(log_l_c)::value;
    cudaError_t err = cudaFuncSetAttribute(
        os_filter_kernel<kLogL>, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return err;
    os_filter_kernel<kLogL><<<static_cast<unsigned>(channels * n_groups), geo.threads, geo.smem,
                              static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, static_cast<const float2*>(tw_fwd), static_cast<const float2*>(tw_inv),
        hr, hi, n, hop, halo, log_t, static_cast<int>(n_groups), geo, scale);
    return cudaGetLastError();
  });
}
