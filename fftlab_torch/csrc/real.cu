// pack_real / interleave / herm_unpack / herm_repack / stft_frames: the
// real-signal path around the half-size complex FFT (pack two reals into
// one complex point, z[j] = x[2j] + i*x[2j+1], m = n/2).
//
// Replaces the TPU kernels
//   fftlab/kernels/rfft_vmem.py `_pack_impl` (`_pack_kernel`),
//     `_interleave_impl` (`_unpack_kernel`) and `_herm_unpack_impl`
//     (`_herm_kernel`): the deinterleave, its inverse and the Hermitian
//     unpack X[k] = E_k + W_n^k * O_k. The TPU kernels are 0/1
//     permutation matmuls because lane gathers were slow there
//     (rfft_vmem.py:4-22); here a float2 load or store of (x[2j], x[2j+1])
//     does the deinterleave, and one thread reads Z[k] and Z[m-k] itself.
//   the first phase of fftlab/kernels/rfft_resident.py
//     `_irfft_resident_kernel` (the Hermitian repack, herm_repack); the
//     rest of K6 is the two-pass pair of fourstep.cu with the pack and
//     interleave fused into its load and store (`kPackedReal`,
//     `kInterleaved`).
//   fftlab/kernels/stft_vmem.py `_pallas_stft_impl` and
//     `_pallas_stft_small_impl` (stft_frames): a block loads T frames
//     straight from the signal at f*hop as float2 pairs, windows them,
//     runs the half-size FFT of each on one shared-memory tile and the
//     Hermitian unpack from the same tile, where both k and m-k are
//     resident. No frame tensor exists; frames past the signal's end read
//     zeros. The output is in natural frame order.
//
// Bound on this card: device memory. Every kernel here moves 8 to 16
// bytes per complex point against a handful of flops (stft_frames: about
// 5 m log2 m flops per frame on fft_size*4 bytes read, overlap included,
// and (m+1)*8 written). Design: one pass each, float2 accesses, and the
// paired unpack/repack (bins k and m-k from one E, W*O computation), so
// Z is read once; the mirrored reads run in descending addresses inside a
// warp and still coalesce. Twiddles are float32 tables built in float64
// on the host; nothing trigonometric runs on the device.

#include <climits>

#include "fft_smem.cuh"

using namespace fftlab;

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kMaxRowsGrid = 65535;

unsigned flat_blocks(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// z[j] = (x[2j], x[2j+1]) over the flat [rows, m] sequence.
__global__ void __launch_bounds__(kThreads)
pack_real_kernel(const float2* __restrict__ x, float* __restrict__ zr, float* __restrict__ zi,
                 long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    const float2 v = x[j];
    zr[j] = v.x;
    zi[j] = v.y;
  }
}

// x[2j], x[2j+1] = zr[j], zi[j]: the inverse of pack_real_kernel.
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                  float2* __restrict__ x, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    x[j] = make_float2(zr[j], zi[j]);
  }
}

// The paired Hermitian unpack of one pair (k, m-k), k = 0..m/2, h = 0.5
// times the output scale, w = W_n^k:
//   E = h*(Z[k] + conj(Z[m-k])),  O = -i*h*(Z[k] - conj(Z[m-k])),
//   X[k] = E + w*O,  X[m-k] = conj(E - w*O)
// (for k = 0, Z[m-k] is Z[0] and X[m-k] is the Nyquist bin X[m]).
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

// Z [rows, m] planes -> X [rows, m+1] planes, bins 0..m. One thread per
// pair (k, m-k); the thread of k = 0 writes the Nyquist bin.
__global__ void __launch_bounds__(kThreads)
herm_unpack_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                   float* __restrict__ xr, float* __restrict__ xi, const float2* __restrict__ tw,
                   long long rows, int m, float h) {
  const int half = m >> 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > half) return;
  const int kk = k == 0 ? 0 : m - k;
  const float2 w = __ldg(tw + k);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t zb = static_cast<size_t>(row) * m;
    const size_t xb = static_cast<size_t>(row) * (m + 1);
    const UnpackPair p = unpack_pair(make_float2(zr[zb + k], zi[zb + k]),
                                     make_float2(zr[zb + kk], zi[zb + kk]), w, h);
    xr[xb + k] = p.low.x;
    xi[xb + k] = p.low.y;
    if (k < half) {
      xr[xb + m - k] = p.high.x;
      xi[xb + m - k] = p.high.y;
    }
  }
}

// X [rows, m+1] planes (bins 0..m) -> Z [rows, m] planes, the paired
// inverse of the unpack with w = W_n^{-k} (the inverse basis):
//   E = (X[k] + conj(X[m-k]))/2,  D = (X[k] - conj(X[m-k]))/2,  O = w*D,
//   Z[k] = E + i*O,  Z[m-k] = conj(E - i*O)   (k = 1..m/2-1).
__global__ void __launch_bounds__(kThreads)
herm_repack_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ zr, float* __restrict__ zi, const float2* __restrict__ tw,
                   long long rows, int m) {
  const int half = m >> 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > half) return;
  const float2 w = __ldg(tw + k);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t xb = static_cast<size_t>(row) * (m + 1);
    const size_t zb = static_cast<size_t>(row) * m;
    const float2 xl = make_float2(xr[xb + k], xi[xb + k]);
    const float2 xh = make_float2(xr[xb + m - k], xi[xb + m - k]);
    const float er = 0.5f * (xl.x + xh.x);
    const float ei = 0.5f * (xl.y - xh.y);
    const float2 o = cmul(make_float2(0.5f * (xl.x - xh.x), 0.5f * (xl.y + xh.y)), w);
    zr[zb + k] = er - o.y;
    zi[zb + k] = ei + o.x;
    if (k > 0 && k < half) {
      zr[zb + m - k] = er + o.y;
      zi[zb + m - k] = o.x - ei;
    }
  }
}

// Writes bin `bin` of a frame's spectrum; with bins = 2m (two-sided) a
// bin in 1..m-1 also writes its conjugate mirror at 2m - bin.
__device__ __forceinline__ void emit_bin(float* __restrict__ yr, float* __restrict__ yi,
                                         size_t base, int bin, int m, int bins, float2 v) {
  yr[base + bin] = v.x;
  yi[base + bin] = v.y;
  if (bins == 2 * m && bin >= 1 && bin < m) {
    yr[base + 2 * m - bin] = v.x;
    yi[base + 2 * m - bin] = -v.y;
  }
}

// One block = T = 2^log_t consecutive frames of fft_size = 2m points.
// Frame f starts at f*hop; element j of its packed sequence is
// (x[f*hop + 2j]*win[2j], x[f*hop + 2j + 1]*win[2j + 1]), stored at
// s[j*T + t] (the layout of fft_smem). tw: W_m^j, m entries; utw:
// W_{2m}^k, k = 0..m/2. y: [n_frames, bins] planes.
__global__ void __launch_bounds__(kMaxThreads)
stft_frames_kernel(const float* __restrict__ x, long long n, const float2* __restrict__ win,
                   const float2* __restrict__ tw, const float2* __restrict__ utw,
                   float* __restrict__ yr, float* __restrict__ yi, long long n_frames, int hop,
                   int log_m, int log_t, int bins) {
  float2* s = smem_tile();
  const int m = 1 << log_m;
  const int t_mask = (1 << log_t) - 1;
  const int tile = m << log_t;
  const long long f0 = static_cast<long long>(blockIdx.x) << log_t;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long f = f0 + (e & t_mask);
    const int j = e >> log_t;
    float2 v = make_float2(0.0f, 0.0f);
    if (f < n_frames) {
      const long long g = f * hop + 2 * j;
      if (g + 1 < n) {
        v = __ldg(reinterpret_cast<const float2*>(x + g));
      } else if (g < n) {
        v.x = __ldg(x + g);
      }
      const float2 w = __ldg(win + j);
      v = make_float2(v.x * w.x, v.y * w.y);
    }
    s[e] = v;
  }
  __syncthreads();
  fft_smem(s, tw, log_m, log_t, -1.0f, 1.0f);
  const int half = m >> 1;
  const int pairs = (half + 1) << log_t;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int t = p & t_mask;
    const long long f = f0 + t;
    if (f >= n_frames) continue;
    const int k = p >> log_t;
    const int kk = k == 0 ? 0 : m - k;
    const UnpackPair q =
        unpack_pair(s[(k << log_t) + t], s[(kk << log_t) + t], __ldg(utw + k), 0.5f);
    const size_t base = static_cast<size_t>(f) * bins;
    emit_bin(yr, yi, base, k, m, bins, q.low);
    if (k < half) emit_bin(yr, yi, base, m - k, m, bins, q.high);
  }
}

// x: [rows, 2m] float32 (8-byte aligned); zr, zi: [rows, m] float32;
// total = rows * m. Returns a cudaError_t.
extern "C" int fftlab_pack_real(const float* x, float* zr, float* zi, long long total,
                                void* stream) {
  if (total < 1) return cudaErrorInvalidValue;
  pack_real_kernel<<<flat_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), zr, zi, total);
  return cudaGetLastError();
}

// zr, zi: [rows, m] float32; x: [rows, 2m] float32 (8-byte aligned);
// total = rows * m. Returns a cudaError_t.
extern "C" int fftlab_interleave(const float* zr, const float* zi, float* x, long long total,
                                 void* stream) {
  if (total < 1) return cudaErrorInvalidValue;
  interleave_kernel<<<flat_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      zr, zi, reinterpret_cast<float2*>(x), total);
  return cudaGetLastError();
}

namespace {

bool pair_grid(long long rows, int m, dim3* grid) {
  if (rows < 1 || m < 2 || (m & 1)) return false;
  const int pairs = (m >> 1) + 1;
  grid->x = static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  grid->y = static_cast<unsigned>(rows < kMaxRowsGrid ? rows : kMaxRowsGrid);
  grid->z = 1;
  return true;
}

}  // namespace

// zr, zi: [rows, m] half-size spectra; xr, xi: [rows, m+1] one-sided
// output; tw: m/2 + 1 float2 twiddles W_{2m}^k; scale multiplies the
// output. m even. Returns a cudaError_t.
extern "C" int fftlab_herm_unpack(const float* zr, const float* zi, float* xr, float* xi,
                                  const void* tw, long long rows, int m, float scale,
                                  void* stream) {
  dim3 grid;
  if (!pair_grid(rows, m, &grid)) return cudaErrorInvalidValue;
  herm_unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      zr, zi, xr, xi, static_cast<const float2*>(tw), rows, m, 0.5f * scale);
  return cudaGetLastError();
}

// xr, xi: [rows, m+1] one-sided spectra; zr, zi: [rows, m] half-size
// spectra for the inverse c2c; tw: m/2 + 1 float2 twiddles W_{2m}^{-k}.
// m even. Returns a cudaError_t.
extern "C" int fftlab_herm_repack(const float* xr, const float* xi, float* zr, float* zi,
                                  const void* tw, long long rows, int m, void* stream) {
  dim3 grid;
  if (!pair_grid(rows, m, &grid)) return cudaErrorInvalidValue;
  herm_repack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, zr, zi, static_cast<const float2*>(tw), rows, m);
  return cudaGetLastError();
}

// x: n float32 samples (8-byte aligned); win: fft_size float32 window
// read as m float2; tw: m float2 twiddles W_m^j; utw: m/2 + 1 float2
// twiddles W_{2m}^k; yr, yi: [n_frames, bins] with bins = m + 1
// (one-sided) or 2m (two-sided). m = 2^log_m, T = 2^log_t frames per
// block, hop even. Returns a cudaError_t.
extern "C" int fftlab_stft_frames(const float* x, long long n, const void* win, const void* tw,
                                  const void* utw, float* yr, float* yi, long long n_frames,
                                  int hop, int log_m, int log_t, int bins, void* stream) {
  const int m = 1 << log_m;
  const int tile = m << log_t;
  const long long blocks = (n_frames + (1LL << log_t) - 1) >> log_t;
  if (log_m < 1 || log_t < 0 || tile > kMaxTile || tile / kPerThread < 32 || n < 1 ||
      n_frames < 1 || blocks > INT_MAX || hop < 2 || (hop & 1) ||
      (bins != m + 1 && bins != 2 * m)) {
    return cudaErrorInvalidValue;
  }
  const int threads = tile / kPerThread;
  const int smem = static_cast<int>(sizeof(float2)) * tile;
  cudaError_t err = cudaFuncSetAttribute(
      stft_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stft_frames_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, n, static_cast<const float2*>(win), static_cast<const float2*>(tw),
      static_cast<const float2*>(utw), yr, yi, n_frames, hop, log_m, log_t, bins);
  return cudaGetLastError();
}
