// The FFT -> H -> IFFT sandwich on the register engine of fft_reg.cuh, for
// every transform of a tile: the forward leaves its spectrum in the
// exchange planes (`forward_in_place`), the inverse's first pass reads it
// there times H, and the inverse's last pass stores. Nothing leaves the SM
// between the two transforms. Used by filter.cu (`filter_rows`,
// `os_filter`: rows and frames, slot mapping 0 throughout) and by
// fourstep.cu (`fourstep_pass2_sandwich`: R rows of the two-pass
// intermediate, runs of 8 rows in the passes that touch H).

#pragma once

#include "fft_reg.cuh"

namespace fftlab {

// Slot mapping 0 in every pass, as a type: `sandwich`'s g for filter.cu's
// rows and frames.
struct MappingZero {
  __device__ __forceinline__ operator int() const { return 0; }
};

// The forward transform of every transform of the tile x (first-pass
// inputs through `load(t, e)`, slot mapping 0) with its outputs left in the
// planes, in natural order; the passes after the first take slot mapping
// g. The passes are Engine::run_in_place's. Its last pass reads all of
// its inputs into registers before a barrier and writes its outputs in
// place after it; the slots of those writes are rebuilt after the barrier
// from z, the barrier's result (0), which the compiler cannot see
// through: otherwise it keeps the reads' plane addresses live across the
// barrier and spills at 4 and 8 slots a thread (ptxas, sm_90a). Returns
// z, the 0 of the closing barrier, for the same use. (The same change in
// Engine::run_in_place cost stft_frames 2.6% at 4096/1024.)
template <int kLogL, int kLogPad, class Load>
__device__ __forceinline__ int forward_in_place(const Tile& x, const float2* __restrict__ tw,
                                                int g, Load load) {
  using Fwd = Engine<kLogL, kLogPad>;
  constexpr int R = Fwd::kLastR;
  constexpr int kLogJ = kLogL - (Fwd::kLogLast == 0 ? 4 : Fwd::kLogLast);  // ns = L/R
  const Fwd fwd{x, 0, g, -1.0f};
  float2 v[kP];
  fwd.load_first(v, load);
  dft<16>(v, 0, -1.0f);
  int log_ns = 0;
  int g_w = 0;
#pragma unroll
  for (int p = 0; p < Fwd::kMid; ++p) {
    fwd.exchange16(v, log_ns, g_w, tw);
    tw += 16 << (log_ns + 4);
    log_ns += 4;
    g_w = g;
  }
  fwd.write16(v, log_ns, g_w);
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
    dft<R>(v, i * R, -1.0f);
  }
  const int z = __syncthreads_or(0);
#pragma unroll
  for (int i = 0; i < kP / R; ++i) {
    int j, t;
    slot_of(i, z + g, kLogJ, j, t);
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
// inputs through `load(t, e)`), times H (`response(t, e)`, the factor of
// element e of transform t), the inverse with `scale`, its outputs through
// the functor `make_store(z)` returns (`store(t, e, value)`); tw_fwd,
// tw_inv: the engine's twiddle tables of L for each direction. Slot
// mappings: the forward's first pass 0 (its loads), its later passes and
// the hand-off g; the inverse's first pass (its reads of H) and its
// later passes g, its last pass 0 (its stores). Every inverse mapping is
// built from z, the result of forward_in_place's closing barrier, which
// the compiler cannot see through, so it does not keep the forward's
// plane addresses (the same slots) live for the inverse (300-1200 bytes
// of spills without it). make_store builds the store's pointers from z
// too, after the hand-off, for the same reason. G is int, or MappingZero
// where every pass takes slot mapping 0 (filter.cu's rows and frames):
// the inverse is then Engine::run with
// its store built before its first pass, the form whose registers ptxas
// keeps free of spills for os_filter's 512 and 1K frames (84 and 68 bytes
// of spills with the store built at the last pass).
template <int kLogL, int kLogPad, class G, class Load, class Response, class MakeStore>
__device__ __forceinline__ void sandwich(const Tile& x, const float2* __restrict__ tw_fwd,
                                         const float2* __restrict__ tw_inv, float scale, G g,
                                         Load load, Response response, MakeStore make_store) {
  using Inv = Engine<kLogL, kLogPad>;
  const int z = forward_in_place<kLogL, kLogPad>(x, tw_fwd, g, load);
  const int g_inv = z + g;
  const Inv inv{x, g_inv, g_inv, 1.0f};
  const auto times_h = [&](int t, int e) {
    const int a = padded<kLogPad>(x, t, e);
    return cmul(make_float2(x.re[a], x.im[a]), response(t, e));
  };
  if constexpr (std::is_same_v<G, MappingZero>) {
    inv.run(tw_inv, scale, times_h, make_store(z));
  } else {
    float2 v[kP];
    inv.load_first(v, times_h);
    dft<16>(v, 0, 1.0f);
    int log_ns = 0;
#pragma unroll
    for (int p = 0; p < Inv::kMid; ++p) {
      inv.exchange16(v, log_ns, g_inv, tw_inv);
      tw_inv += 16 << (log_ns + 4);
      log_ns += 4;
    }
    const Inv out{x, z, z, 1.0f};
    out.last(v, log_ns, g_inv, tw_inv, scale, make_store(z));
  }
}

}  // namespace fftlab
