// The paired Hermitian unpack of the pack-two-reals r2c, shared by
// real.cu (`herm_unpack`, `stft_frames`) and fourstep.cu (pass 2's unpack
// mode, `fourstep_pass2_unpack`).

#pragma once

#include "fft_reg.cuh"

namespace fftlab {

// The paired Hermitian unpack of one pair (k, m-k), h = 0.5 times the
// output scale, w = W_n^k (n = 2m):
//   E = h*(Z[k] + conj(Z[m-k])),  O = -i*h*(Z[k] - conj(Z[m-k])),
//   X[k] = E + w*O,  X[m-k] = conj(E - w*O)
// (for k = 0, Z[m-k] is Z[0] and X[m-k] is the Nyquist bin X[m]). Either
// member of a pair may be k: with k and m-k swapped, the two outputs swap.
struct UnpackPair {
  float2 low;   // X[k]
  float2 high;  // X[m-k]
};

__device__ __forceinline__ UnpackPair unpack_pair(float2 zl, float2 zh, float2 w, float h) {
  const float er = h * (zl.x + zh.x);
  const float ei = h * (zl.y - zh.y);
  const float2 o = make_float2(h * (zl.y + zh.y), -h * (zl.x - zh.x));
  const float2 wo = cmul(o, w);
  return {make_float2(er + wo.x, ei + wo.y), make_float2(er - wo.x, wo.y - ei)};
}

}  // namespace fftlab
