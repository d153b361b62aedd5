// Shared device code: the register-resident FFT engine of `fft_rows`, of
// the two-pass pair and the stages of the stage pipeline (fourstep.cu),
// of `stft_frames` (real.cu) and of the filter sandwiches `filter_rows`
// and `os_filter` (filter.cu). A length-L FFT (L = 2^log_l, 2 <= L <=
// 16384) down each of the T = 2^log_t transforms of a tile, Stockham
// autosort, natural order in and out.
//
// Each thread holds kP = 16 complex values in registers for a whole pass.
// The length is a template parameter (the kernels are instantiated for
// each L their windows use): with L, its schedule and the pad known to
// the compiler, every pass's offsets fold into immediates, and the
// kernels fit the 64 registers that 1024 threads (or two blocks of 512)
// leave each thread, with no spills.
// The passes are radix 16 (four radix-2 levels with no shared memory in
// between), and the leftover bits of L make one last pass of radix 8, 4
// or 2: 16384 = 16*16*16*4 takes 4 passes and 3 exchanges, 1024 =
// 16*16*4 and 2048 = 16*16*8 take 2, 256 = 16*16, 128 = 16*8, 64 = 16*4
// and 32 = 16*2 take 1. A length of at most 16 is one pass with no
// exchange and no shared memory (`run_short`): a thread holds 16/L whole
// transforms and runs their L-point DFTs in registers.
// The first pass reads its inputs straight from device memory (through
// the caller's `load`), the last pass writes its outputs straight back
// (through `store`), so the tile crosses shared memory only between
// passes; `run_in_place` instead leaves the outputs in the planes, for a
// kernel that works on the spectrum in shared memory afterwards (the
// STFT's Hermitian unpack). A tile of T*L values runs on exactly T*L/16
// threads.
//
// Pass p (radix R, sub-transform length ns): butterfly j of transform t
// reads elements j + r*L/R, multiplies input r by W_{ns*R}^{r*(j mod ns)},
// runs the R-point DFT and writes output r to (j/ns)*ns*R + j mod ns +
// r*ns. A thread holds 16/R butterflies (slots) per pass. Slot s maps to
// (j, t) by its bits: the lowest g pick the low bits of t (so 2^g
// neighbouring threads hold neighbouring transforms), the next log2(L/R)
// pick j, the rest the high bits of t. The caller picks g per pass so
// that its device-memory accesses coalesce: g = 3 where a run of
// transforms is contiguous in device memory (pass 1's columns, pass 2's
// corner-turned store), 4 where it is a row of 16 (the stage pipeline's
// stages), g = 0 where a transform is (a row).
//
// Exchange layout: split float planes, re then im. A tile (T > 1) puts
// element e of transform t at t*stride + e + (e >> 4): one pad float
// every 16 and a row stride of L + L/16 + 4 (+ 2 in the stages of length
// 64 and 128, whose slot mapping is 4). A single row has no pad: it
// puts element e at e ^ ((e >> 4) & 31), bits 0..4 of e XORed with bits
// 4..8. A tile whose every pass puts neighbouring threads on neighbouring
// elements of one transform (slot mapping g = 0 throughout: the filter
// kernels of filter.cu) stacks such rows instead, element e of transform
// t at t*stride + (e ^ ((e >> 4) & 31)), stride a multiple of 32
// (`kFrameRows`). Every exchange store and load of every pass then takes
// one wavefront per 32 floats in a row, in stacked rows and in a tile of
// 8 or 16 transforms at L >= 512, and at most two in the smaller tiles (a
// model of the accesses chose the layouts and checks them:
// tests/test_torch_geometry.py).
//
// Twiddles: one float32 table per length L, built on the host in
// float64 (kernels/_common.py `pass_twiddle_np`): for each pass after the
// first (ns > 1), the values W_{ns*R}^{r*k} (r < R, k < ns; r = 0 is 1)
// as R/2 rows of ns pairs (W^{2h*k}, W^{(2h+1)*k}), the passes one after
// another. A thread loads the twiddles of each of its butterflies once
// per pass, as R/2 16-byte loads at constant distances from one address,
// and a warp's load of one row is contiguous; nothing trigonometric runs
// on the device, and no twiddle is built from another.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace fftlab {

constexpr int kP = 16;            // complex values per thread
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

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

// The launch geometry, chosen by the Python wrapper and checked by the
// launcher (`valid_geometry`): threads = T*L/16, the shared bytes of the
// exchange planes, the radix of the last pass (2^log_last, 0 when every
// pass is radix 16) and the plane layout.
struct Geometry {
  int threads;
  int smem;
  int log_last;
  int log_pad;
  int stride;
};

// The layout of stacked swizzled rows (`padded<kFrameRows>`), in the place
// of a log_pad.
constexpr int kFrameRows = -1;

// The geometry of a kernel whose layout is log_pad (one pad float every
// 2^log_pad; 0: the single row's swizzle, no pad; kFrameRows: stacked
// swizzled rows), for T = 2^log_t transforms of length 2^log_l, T at
// most 2^max_log_t. The launchers' `dispatch` ranges bound the length.
inline bool valid_geometry(const Geometry& g, int log_l, int log_t, int log_pad,
                           int max_log_t = 4) {
  if (log_l < 1 || log_l > 14 || log_t < 0 || log_t > max_log_t || g.log_pad != log_pad) {
    return false;
  }
  const long long L = 1LL << log_l;
  const long long T = 1LL << log_t;
  // the schedule: radix-16 passes, then one of radix 2^(log_l mod 4)
  if (g.log_last != (log_l & 3)) return false;
  if (g.threads != T * L / kP || g.threads > kMaxThreads || g.threads % 32 != 0) return false;
  if (log_l <= 4) return g.smem == 0;  // one pass in registers: no exchange
  if (g.stride < (log_pad <= 0 ? L : L + ((L - 1) >> log_pad) + 1)) return false;
  if (log_pad == kFrameRows && g.stride % 32 != 0) return false;
  return g.smem >= 8 * T * g.stride && g.smem <= kMaxSmem;
}

// The blocks per SM that a kernel of at most kThreads threads is built
// for (its __launch_bounds__): 1024 threads per SM, so 64 registers a
// thread, down to 512-thread blocks (two 8K-value tiles, or one 16K); 768
// threads per SM below, whose 85 registers keep the 4K-value tiles and
// the short rows free of spills.
template <int kThreads>
constexpr int blocks_per_sm() {
  return kThreads >= 512 ? 1024 / kThreads : 768 / kThreads;
}

// Calls f(std::integral_constant<int, v>) for the v = value in [kLo, kHi],
// and returns what it returns; cudaErrorInvalidValue outside the range.
template <int kLo, int kHi, class F>
cudaError_t dispatch(int value, F&& f) {
  if constexpr (kLo > kHi) {
    return cudaErrorInvalidValue;
  } else {
    if (value == kLo) return f(std::integral_constant<int, kLo>{});
    return dispatch<kLo + 1, kHi>(value, f);
  }
}

// The exchange planes of a block: element e of transform t at
// `padded<kLogPad>(x, t, e)` of each.
struct Tile {
  float* re;
  float* im;
  int stride;
};

__device__ __forceinline__ Tile make_tile(int log_t, const Geometry& g) {
  float* re = reinterpret_cast<float*>(smem_tile());
  return Tile{re, re + (g.stride << log_t), g.stride};
}

template <int kLogPad>
__device__ __forceinline__ int padded(const Tile& x, int t, int e) {
  if constexpr (kLogPad == 0) {
    return e ^ ((e >> 4) & 31);  // a single row (t = 0)
  } else if constexpr (kLogPad == kFrameRows) {
    return t * x.stride + (e ^ ((e >> 4) & 31));
  } else {
    return t * x.stride + e + (e >> kLogPad);
  }
}

// a * W_16^m, W_16 = exp(sign * 2*pi*i / 16); m is a constant once the
// callers' loops unroll, so the switch folds away. The literals are
// cos/sin(2*pi*m/16) rounded to float32.
__device__ __forceinline__ float2 w16(float2 a, int m, float sign) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f;
  constexpr float h = 0.707106781186547524f;
  switch (m & 15) {
    case 0: return a;
    case 1: return cmul(a, make_float2(c1, sign * s1));
    case 2: return cmul(a, make_float2(h, sign * h));
    case 3: return cmul(a, make_float2(s1, sign * c1));
    case 4: return rot(a, sign);
    case 6: return cmul(a, make_float2(-h, sign * h));
    case 9: return cmul(a, make_float2(-c1, -sign * s1));
    default: return a;  // not reached: the DFTs below use m in {0..4, 6, 9}
  }
}

__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3, float sign) {
  const float2 t0 = cadd(a0, a2);
  const float2 t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3);
  const float2 t3 = rot(csub(a1, a3), sign);
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// X[k1 + 4*k2] = sum_n2 W_2^{n2*k2} W_8^{n2*k1} sum_n1 x[2*n1 + n2] W_4^{n1*k1}
template <int N>
__device__ __forceinline__ void dft8(float2 (&x)[N], int o, float sign) {
  float2 y[8];
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
    float2 a0 = x[o + n2], a1 = x[o + n2 + 2], a2 = x[o + n2 + 4], a3 = x[o + n2 + 6];
    dft4(a0, a1, a2, a3, sign);
    y[4 * n2] = a0;
    y[4 * n2 + 1] = w16(a1, 2 * n2, sign);
    y[4 * n2 + 2] = w16(a2, 4 * n2, sign);
    y[4 * n2 + 3] = w16(a3, 6 * n2, sign);
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft2(y[k1], y[4 + k1]);
    x[o + k1] = y[k1];
    x[o + k1 + 4] = y[4 + k1];
  }
}

// X[k1 + 4*k2] = sum_n2 W_4^{n2*k2} W_16^{n2*k1} sum_n1 x[4*n1 + n2] W_4^{n1*k1}:
// the first stage (the DFTs over n1 and the W_16 twiddles) into y, at
// y[4*n2 + k1].
template <int N>
__device__ __forceinline__ void dft16_first(const float2 (&x)[N], int o, float sign,
                                            float2 (&y)[16]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 a0 = x[o + n2], a1 = x[o + n2 + 4], a2 = x[o + n2 + 8], a3 = x[o + n2 + 12];
    dft4(a0, a1, a2, a3, sign);
    y[4 * n2] = a0;
    y[4 * n2 + 1] = w16(a1, n2, sign);
    y[4 * n2 + 2] = w16(a2, 2 * n2, sign);
    y[4 * n2 + 3] = w16(a3, 3 * n2, sign);
  }
}

template <int N>
__device__ __forceinline__ void dft16(float2 (&x)[N], int o, float sign) {
  float2 y[16];
  dft16_first(x, o, sign, y);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft4(y[k1], y[4 + k1], y[8 + k1], y[12 + k1], sign);
    x[o + k1] = y[k1];
    x[o + k1 + 4] = y[4 + k1];
    x[o + k1 + 8] = y[8 + k1];
    x[o + k1 + 12] = y[12 + k1];
  }
}

// The R-point DFT of x[o .. o + R), in place, natural order out.
template <int R, int N>
__device__ __forceinline__ void dft(float2 (&x)[N], int o, float sign) {
  if constexpr (R == 2) {
    dft2(x[o], x[o + 1]);
  } else if constexpr (R == 4) {
    dft4(x[o], x[o + 1], x[o + 2], x[o + 3], sign);
  } else if constexpr (R == 8) {
    dft8(x, o, sign);
  } else {
    dft16(x, o, sign);
  }
}

// Input r of butterfly class k < ns of a radix-R pass times W^{r*k}, from
// the pass's rows of twiddle pairs at `tw` (16-byte aligned: the table and
// every pass's rows start on an even entry).
template <int R, int N>
__device__ __forceinline__ void twiddle(float2 (&v)[N], int o, const float2* __restrict__ tw,
                                        int k, int ns) {
  const float4* __restrict__ q = reinterpret_cast<const float4*>(tw) + k;
#pragma unroll
  for (int h = 0; h < R / 2; ++h) {
    const float4 w = __ldg(q + h * ns);
    if (h > 0) v[o + 2 * h] = cmul(v[o + 2 * h], make_float2(w.x, w.y));
    v[o + 2 * h + 1] = cmul(v[o + 2 * h + 1], make_float2(w.z, w.w));
  }
}

// The default of `Engine::run`'s `after_load`: nothing.
struct NoWork {
  __device__ __forceinline__ void operator()() const {}
};

// Butterfly j and transform t of slot i of this thread, in a pass whose
// transforms have 2^log_j butterflies.
__device__ __forceinline__ void slot_of(int i, int g, int log_j, int& j, int& t) {
  const int s = threadIdx.x + i * blockDim.x;
  const int hi = s >> g;
  j = hi & ((1 << log_j) - 1);
  t = ((hi >> log_j) << g) | (s & ((1 << g) - 1));
}

// The length-L transform (L = 2^kLogL) of every transform of a tile, its
// exchanges in padded planes (one pad float every 2^kLogPad; kLogPad = 0:
// a single row, swizzled).
template <int kLogL, int kLogPad>
struct Engine {
  static constexpr int kLogLast = kLogL & 3;  // the last pass's radix: 2^kLogLast, or 16
  static constexpr int kLastR = kLogLast == 0 ? 16 : 1 << kLogLast;
  // radix-16 passes between the first and the last (kLogL >= 5: at
  // least two passes in all; shorter lengths take `run_short`)
  static constexpr int kMid = (kLogL >> 2) - (kLogLast == 0 ? 2 : 1);

  const Tile x;
  const int g_first;  // slot mapping of the first pass
  const int g;        // slot mapping of every later pass
  const float sign;

  // The first pass's inputs, element j + r*L/16 through `load(t, e)`.
  template <class Load>
  __device__ __forceinline__ void load_first(float2 (&v)[kP], Load load) const {
    constexpr int kLogJ = kLogL - 4;
    int j, t;
    slot_of(0, g_first, kLogJ, j, t);
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = load(t, j + (r << kLogJ));
  }

  // A radix-16 pass after the first: the outputs of the previous pass
  // (at ns = 2^log_ns, slots mapped with g_w) into the planes, after a
  // barrier that ends every read of the last exchange; a barrier; this
  // pass's inputs, its twiddles (records at `tw`) and its DFT.
  __device__ __forceinline__ void exchange16(float2 (&v)[kP], int log_ns, int g_w,
                                             const float2* __restrict__ tw) const {
    write16(v, log_ns, g_w);
    constexpr int kLogJ = kLogL - 4;
    int j, t;
    slot_of(0, g, kLogJ, j, t);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int a = padded<kLogPad>(x, t, j + (r << kLogJ));
      v[r] = make_float2(x.re[a], x.im[a]);
    }
    twiddle<16>(v, 0, tw, j & ((16 << log_ns) - 1), 16 << log_ns);
    dft<16>(v, 0, sign);
  }

  __device__ __forceinline__ void write16(const float2 (&v)[kP], int log_ns, int g_w) const {
    __syncthreads();
    int j, t;
    slot_of(0, g_w, kLogL - 4, j, t);
    const int base = ((j >> log_ns) << (log_ns + 4)) + (j & ((1 << log_ns) - 1));
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int a = padded<kLogPad>(x, t, base + (r << log_ns));
      x.re[a] = v[r].x;
      x.im[a] = v[r].y;
    }
    __syncthreads();
  }

  // The last pass (radix kLastR, ns = L/kLastR), after the exchange of the
  // radix-16 pass before it (at 2^log_ns). Output r of butterfly j of
  // transform t is element j + r*L/R, times `scale`, through
  // `store(t, e, value)`. The epilogue's loads (H, a twiddle factor)
  // are kept to a few outputs at a time, in loops the compiler does not
  // unroll: a radix-8, 4 or 2 pass runs one slot at a time, and a radix-16
  // pass (one slot) runs its DFT's second stage and its stores one group
  // of four outputs at a time.
  template <class Store>
  __device__ __forceinline__ void last(const float2 (&v)[kP], int log_ns, int g_w,
                                       const float2* __restrict__ tw, float scale,
                                       Store store) const {
    constexpr int R = kLastR;
    constexpr int kLogJ = kLogL - (kLogLast == 0 ? 4 : kLogLast);  // k = j: ns = L/R
    write16(v, log_ns, g_w);
    auto out = [&](int t, int e, float2 y) {
      store(t, e, make_float2(y.x * scale, y.y * scale));
    };
#pragma unroll 1
    for (int i = 0; i < kP / R; ++i) {
      int j, t;
      slot_of(i, g, kLogJ, j, t);
      float2 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = padded<kLogPad>(x, t, j + (r << kLogJ));
        a[r] = make_float2(x.re[at], x.im[at]);
      }
      twiddle<R>(a, 0, tw, j, 1 << kLogJ);
      if constexpr (R == 16) {
        float2 y[16];
        dft16_first(a, 0, sign, y);
#pragma unroll 1
        for (int k1 = 0; k1 < 4; ++k1) {  // outputs k1 + 4*k2 from y[4*k2]
          float2 b0 = y[0], b1 = y[4], b2 = y[8], b3 = y[12];
          dft4(b0, b1, b2, b3, sign);
          out(t, j + (k1 << kLogJ), b0);
          out(t, j + ((k1 + 4) << kLogJ), b1);
          out(t, j + ((k1 + 8) << kLogJ), b2);
          out(t, j + ((k1 + 12) << kLogJ), b3);
#pragma unroll
          for (int m = 0; m < 16; m += 4) {  // the next k1 to y[4*k2]
            y[m] = y[m + 1];
            y[m + 1] = y[m + 2];
            y[m + 2] = y[m + 3];
          }
        }
      } else {
        dft<R>(a, 0, sign);
#pragma unroll
        for (int r = 0; r < R; ++r) out(t, j + (r << kLogJ), a[r]);
      }
    }
  }

  // A length of at most 16: one pass, no exchange, no twiddle table. The
  // block's kThreads threads (its blockDim.x, a constant here) hold its
  // 16/L*kThreads transforms, thread s the transforms s + i*kThreads (i <
  // 16/L), so 32 neighbouring threads hold 32 neighbouring transforms at
  // every load and store, and the compiler sees what a thread's transforms
  // share (their offset mod 16, so one load of the stage's twiddle
  // factors serves them all). All 16 loads are issued before the first
  // DFT; the outputs go to `store(t, e, value)` unscaled.
  template <int kThreads, class Load, class Store>
  __device__ __forceinline__ void run_short(Load load, Store store) const {
    static_assert(kLogL <= 4, "run_short takes lengths of at most 16");
    constexpr int L = 1 << kLogL;
    float2 v[kP];
#pragma unroll
    for (int i = 0; i < kP / L; ++i) {
#pragma unroll
      for (int e = 0; e < L; ++e) v[i * L + e] = load(threadIdx.x + i * kThreads, e);
    }
#pragma unroll
    for (int i = 0; i < kP / L; ++i) {
      dft<L>(v, i * L, sign);
#pragma unroll
      for (int e = 0; e < L; ++e) store(threadIdx.x + i * kThreads, e, v[i * L + e]);
    }
  }

  // The whole transform: inputs through `load(t, e)`, outputs times
  // `scale` through `store(t, e, value)`; `tw` is the twiddle table of L.
  // `after_load()` runs once the first pass's loads are issued, before any
  // barrier: a caller's own loads there wait beside them, and what it puts
  // in shared memory outside the planes is readable by every thread from
  // the first exchange on.
  template <class Load, class Store, class AfterLoad = NoWork>
  __device__ __forceinline__ void run(const float2* __restrict__ tw, float scale, Load load,
                                      Store store, AfterLoad after_load = {}) const {
    float2 v[kP];
    load_first(v, load);
    after_load();
    dft<16>(v, 0, sign);  // ns = 1: no twiddles
    int log_ns = 0;
    int g_w = g_first;
#pragma unroll
    for (int p = 0; p < kMid; ++p) {
      exchange16(v, log_ns, g_w, tw);
      tw += 16 << (log_ns + 4);  // the next pass's twiddles
      log_ns += 4;
      g_w = g;
    }
    last(v, log_ns, g_w, tw, scale, store);
  }

  // The whole transform with its outputs left in the planes: element e of
  // transform t at padded(t, e), natural order. The passes are `run`'s;
  // the last one reads all of its inputs into registers before a barrier
  // and writes its outputs in place after it, and a closing barrier makes
  // every output readable by every thread.
  template <class Load>
  __device__ __forceinline__ void run_in_place(const float2* __restrict__ tw, Load load) const {
    constexpr int R = kLastR;
    constexpr int kLogJ = kLogL - (kLogLast == 0 ? 4 : kLogLast);  // k = j: ns = L/R
    float2 v[kP];
    load_first(v, load);
    dft<16>(v, 0, sign);
    int log_ns = 0;
    int g_w = g_first;
#pragma unroll
    for (int p = 0; p < kMid; ++p) {
      exchange16(v, log_ns, g_w, tw);
      tw += 16 << (log_ns + 4);
      log_ns += 4;
      g_w = g;
    }
    write16(v, log_ns, g_w);
#pragma unroll
    for (int i = 0; i < kP / R; ++i) {
      int j, t;
      slot_of(i, g, kLogJ, j, t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = padded<kLogPad>(x, t, j + (r << kLogJ));
        v[i * R + r] = make_float2(x.re[at], x.im[at]);
      }
      twiddle<R>(v, i * R, tw, j, 1 << kLogJ);
      dft<R>(v, i * R, sign);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kP / R; ++i) {
      int j, t;
      slot_of(i, g, kLogJ, j, t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = padded<kLogPad>(x, t, j + (r << kLogJ));
        x.re[at] = v[i * R + r].x;
        x.im[at] = v[i * R + r].y;
      }
    }
    __syncthreads();
  }
};

}  // namespace fftlab
