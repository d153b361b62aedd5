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
//     `_pallas_stft_small_impl` (stft_frames), described below.
//
// Bound on this card: device memory. Every kernel here moves 8 to 16
// bytes per complex point against a handful of flops. Design: one pass
// each, float2 accesses, and the paired unpack/repack (bins k and m-k
// from one E, W*O computation), so Z is read once; the mirrored reads run
// in descending addresses inside a warp and still coalesce. Twiddles are
// float32 tables built in float64 on the host; nothing trigonometric runs
// on the device.
//
// stft_frames is bound by its output: (m+1)*8 bytes per frame one-sided,
// 16m two-sided, against a read of hop*4 bytes (the frames overlap) and
// about 5 m log2 m flops. The output rows are bins = m+1 or 2m floats
// long, so a store that puts neighbouring threads on neighbouring frames
// (one thread per bin and frame) lands each 4-byte store bins*4 bytes from
// the next, one 32-byte sector per store: at 256/128 an eighth of each
// sector carried data. Design, one block per T consecutive frames
// f0..f0+T-1:
//   1. the block's span of the signal, x[f0*hop, (f0+T-1)*hop + fft_size),
//      is read once into shared memory in 16-byte words, neighbouring
//      threads on neighbouring words (with hop > fft_size, each frame's
//      run instead), and the window beside it, as asynchronous copies
//      that are all in flight at once; samples past the signal's end
//      read zeros;
//   2. the m-point FFT of each packed frame z[j] = x[2j] + i*x[2j+1] runs
//      on the register engine (fft_reg.cuh, `run_in_place`), its first
//      pass reading the windowed pairs from the span, its spectrum left
//      in the exchange planes;
//   3. the Hermitian unpack reads Z[k] and Z[m-k] there and writes bins k
//      and m-k (and the two-sided mirrors 2m-k, m+k) into a staging area
//      laid out as the output rows f0..f0+T-1: one contiguous run of
//      T*bins floats per plane;
//   4. neighbouring threads store neighbouring 16-byte words of that run
//      (the staging area is shifted so that its words line up with the
//      output's; an unaligned head and tail go as single floats).
// The staging area reuses the planes and the span once the FFT is done.

#include <climits>
#include <cstdint>

#include "hermitian.cuh"

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

// ------------------------------------------------------------ stft_frames

// The signal's place in shared memory: float u of a segment at
// span_at(u), four pad floats after every 32, so that two frames 128
// floats apart, read by one half-warp, fall on the two halves of the
// banks (a model of the accesses: tests/test_torch_geometry.py). A
// 16-byte word stays one aligned float4 and a pair (x[2j], x[2j+1]) one
// aligned float2.
__host__ __device__ __forceinline__ int span_at(int u) { return u + 4 * (u >> 5); }

// The shared memory of one block, in floats, as kernels/stft_vmem.py
// `stft_layout` lays it out (`valid_layout` checks that it holds what the
// kernel reads and writes): the engine's exchange planes from 0
// (2*T*stride floats), then nseg segments of the signal from `span`,
// seg_pitch floats apart (one segment, the block's span, where hop <=
// fft_size; one per frame above), each `words` 16-byte words, then the
// window (fft_size floats) at `window`. Once the FFT is done, the staging
// area of the output overlays them from 0: two planes of stage_pitch
// floats, T*bins each plus 3 for the alignment shift.
struct StftLayout {
  int nseg, words, seg_pitch, span, window, stage_pitch, total;
};

// Whether `s` fits T frames of fft_size = 2m at stride `hop`, bins
// floats out per frame, planes of `stride`, in `smem` bytes: every
// region in place and apart from the next, 16-byte words aligned.
inline bool valid_layout(const StftLayout& s, int m, int hop, int T, int stride, int bins,
                         int smem) {
  const long long fft_size = 2LL * m;
  const long long seg_len = s.nseg == 1 ? (T - 1LL) * hop + fft_size : fft_size;
  return s.nseg == (hop <= fft_size ? 1 : T) && s.words > 0 && s.words <= kMaxSmem / 16 &&
         4LL * s.words >= seg_len + 3 &&  // a lead of up to 3 floats before the first sample
         s.seg_pitch % 4 == 0 && s.seg_pitch >= span_at(4 * (s.words - 1)) + 4 &&
         s.span % 4 == 0 && s.span >= 2LL * T * stride && s.window % 2 == 0 &&
         s.window >= s.span + static_cast<long long>(s.nseg) * s.seg_pitch &&
         s.stage_pitch % 4 == 0 && s.stage_pitch >= static_cast<long long>(T) * bins + 3 &&
         s.total >= s.window + fft_size && s.total >= 2LL * s.stage_pitch &&
         4LL * s.total <= smem;
}

// Asynchronous copies into shared memory (cp.async): a 16-byte word whose
// floats from `valid` on read as zeros, and an 8-byte pair. Every thread
// issues all of its copies before it waits for any (`wait_copies`), so a
// block's loads overlap one another instead of costing a round trip each.
__device__ __forceinline__ void copy_word_async(float* dst, const float* src, int valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(4 * valid));
#else
  for (int i = 0; i < 4; ++i) dst[i] = i < valid ? src[i] : 0.0f;
#endif
}

__device__ __forceinline__ void copy_pair_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
#else
  dst[0] = src[0];
  dst[1] = src[1];
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Writes bin `bin` of frame row `row` (= t*bins) of the staging planes;
// with bins = 2m (two-sided) a bin in 1..m-1 also writes its conjugate
// mirror at 2m - bin.
__device__ __forceinline__ void stage_bin(float* sr, float* si, int row, int bin, int m, int bins,
                                          float2 v) {
  sr[row + bin] = v.x;
  si[row + bin] = v.y;
  if (bins == 2 * m && bin >= 1 && bin < m) {
    sr[row + 2 * m - bin] = v.x;
    si[row + 2 * m - bin] = -v.y;
  }
}

// Copies `total` floats from the staging plane s to the output y, whose
// float offset from a 16-byte boundary is also s's: single floats up to
// y's first 16-byte word, then 16-byte words, then single floats.
__device__ __forceinline__ void store_run(const float* s, float* __restrict__ y, int total,
                                          int shift) {
  const int head = min((4 - shift) & 3, total);
  const int words = (total - head) >> 2;
  if (static_cast<int>(threadIdx.x) < head) y[threadIdx.x] = s[threadIdx.x];
  for (int q = threadIdx.x; q < words; q += blockDim.x) {
    reinterpret_cast<float4*>(y + head)[q] = reinterpret_cast<const float4*>(s + head)[q];
  }
  const int tail = head + 4 * words + threadIdx.x;
  if (tail < total) y[tail] = s[tail];
}

// The most threads of a block of length-2^kLogM frames: T*m <= 4096
// values where T > 1, one frame above m = 1024.
template <int kLogM>
constexpr int stft_threads() {
  return kLogM > 10 ? 1 << (kLogM - 4) : 256;
}

// The blocks per SM a kernel is built for: one frame of m > 1024 takes
// 50 to 200 KB of shared memory, so 4 to 1 blocks (128 registers).
template <int kLogM>
constexpr int stft_blocks() {
  return kLogM > 10 ? 1 << (13 - kLogM) : blocks_per_sm<256>();
}

// One block = T = 2^log_t consecutive frames of fft_size = 2m points,
// m = 2^kLogM. Frame f starts at f*hop; element j of its packed sequence
// is (x[f*hop + 2j]*win[2j], x[f*hop + 2j + 1]*win[2j + 1]). tw: the
// engine's twiddle table for m; utw: W_{2m}^k, k = 0..m/2. y:
// [n_frames, bins] planes. kLogPad: the planes' layout (fft_reg.cuh), 0
// for one frame per block.
template <int kLogM, int kLogPad>
__global__ void __launch_bounds__(stft_threads<kLogM>(), stft_blocks<kLogM>())
stft_frames_kernel(const float* __restrict__ x, long long n, const float* __restrict__ win,
                   const float2* __restrict__ tw, const float2* __restrict__ utw,
                   float* __restrict__ yr, float* __restrict__ yi, long long n_frames, int hop,
                   int log_t, int bins, Geometry geo, StftLayout lay) {
  constexpr int m = 1 << kLogM;
  const int T = 1 << log_t;
  float* smem = reinterpret_cast<float*>(smem_tile());
  const long long f0 = static_cast<long long>(blockIdx.x) << log_t;
  // x's offset from a 16-byte boundary, in floats (x is 8-byte aligned)
  const int x_shift = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  // 1. the signal: segment s starts at sample (f0 + s)*hop, read from the
  // 16-byte word that holds it (`lead` floats before it; the floats
  // before x[0] in that word are never used, those from x[n] on read as
  // zeros, and a word wholly past the end reads nothing)
  for (int q = threadIdx.x; q < lay.nseg * lay.words; q += blockDim.x) {
    const int s = q / lay.words;
    const int w = q - s * lay.words;
    const long long g0 = (f0 + s) * hop;
    const long long g = g0 - ((x_shift + g0) & 3) + 4 * w;
    const long long valid = n - g < 4 ? (n - g > 0 ? n - g : 0) : 4;
    copy_word_async(smem + lay.span + s * lay.seg_pitch + span_at(4 * w),
                    valid > 0 ? x + g : x - x_shift, static_cast<int>(valid));
  }
  float2* win2 = reinterpret_cast<float2*>(smem + lay.window);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    copy_pair_async(reinterpret_cast<float*>(win2 + j), win + 2 * j);
  }
  wait_copies();
  __syncthreads();
  // 2. the FFT of every frame, its spectrum left in the planes
  const bool one_span = lay.nseg == 1;
  const Engine<kLogM, kLogPad> engine{make_tile(log_t, geo), 0, log_t < 3 ? log_t : 3, -1.0f};
  engine.run_in_place(tw, [&](int t, int j) {
    const int s = one_span ? 0 : t;
    const int lead = static_cast<int>((x_shift + (f0 + s) * hop) & 3);
    const int u = lead + (one_span ? t * hop : 0) + 2 * j;
    const float2 v =
        *reinterpret_cast<const float2*>(smem + lay.span + s * lay.seg_pitch + span_at(u));
    const float2 w = win2[j];
    return make_float2(v.x * w.x, v.y * w.y);
  });
  // 3. the unpack of pairs (k, m-k), k < m/2, into registers: 8 per
  // thread, k fastest across the threads; the middle bin m/2 of frame t
  // by thread t
  constexpr int kPairs = 8;  // T*m/2 pairs on T*m/16 threads
  constexpr int half = m / 2;
  const Tile& z = engine.x;
  float2 zl[kPairs], zh[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    const int t = p >> (kLogM - 1);
    const int k = p & (half - 1);
    const int a = padded<kLogPad>(z, t, k);
    const int b = padded<kLogPad>(z, t, k == 0 ? 0 : m - k);
    zl[i] = make_float2(z.re[a], z.im[a]);
    zh[i] = make_float2(z.re[b], z.im[b]);
  }
  const bool mid = static_cast<int>(threadIdx.x) < T;
  float2 zm = make_float2(0.0f, 0.0f);
  if (mid) {
    const int a = padded<kLogPad>(z, threadIdx.x, half);
    zm = make_float2(z.re[a], z.im[a]);
  }
  __syncthreads();  // every read of the planes is done: the staging area reuses them
  const size_t out0 = static_cast<size_t>(f0) * bins;
  const int shift_r = static_cast<int>((reinterpret_cast<uintptr_t>(yr + out0) >> 2) & 3);
  const int shift_i = static_cast<int>((reinterpret_cast<uintptr_t>(yi + out0) >> 2) & 3);
  float* sr = smem + shift_r;
  float* si = smem + lay.stage_pitch + shift_i;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    const int t = p >> (kLogM - 1);
    const int k = p & (half - 1);
    const UnpackPair q = unpack_pair(zl[i], zh[i], __ldg(utw + k), 0.5f);
    stage_bin(sr, si, t * bins, k, m, bins, q.low);
    stage_bin(sr, si, t * bins, m - k, m, bins, q.high);  // k = 0: the Nyquist bin m
  }
  if (mid) {
    stage_bin(sr, si, threadIdx.x * bins, half, m, bins,
              unpack_pair(zm, zm, __ldg(utw + half), 0.5f).low);
  }
  __syncthreads();
  // 4. the block's rows as one run per plane
  const long long left = n_frames - f0;
  const int total = static_cast<int>(left < T ? left : T) * bins;
  store_run(sr, yr + out0, total, shift_r);
  store_run(si, yi + out0, total, shift_i);
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

namespace {

// Launches stft_frames_kernel<kLogM, kLogPad> after setting its shared
// memory.
template <int kLogM, int kLogPad>
cudaError_t launch_stft(unsigned blocks, const Geometry& geo, void* stream, const float* x,
                        long long n, const float* win, const void* tw, const void* utw,
                        float* yr, float* yi, long long n_frames, int hop, int log_t,
                        int bins, const StftLayout& lay) {
  cudaError_t err = cudaFuncSetAttribute(stft_frames_kernel<kLogM, kLogPad>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  stft_frames_kernel<kLogM, kLogPad><<<blocks, geo.threads, geo.smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      x, n, win, static_cast<const float2*>(tw), static_cast<const float2*>(utw), yr, yi,
      n_frames, hop, log_t, bins, geo, lay);
  return cudaGetLastError();
}

}  // namespace

// x: n float32 samples (8-byte aligned); win: fft_size float32 window
// (8-byte aligned); tw: the register engine's twiddle table for m; utw:
// m/2 + 1 float2 twiddles W_{2m}^k; yr, yi: [n_frames, bins] with bins =
// m + 1 (one-sided) or 2m (two-sided). m = 2^log_m in 64..8192; T =
// 2^log_t frames per block, T*m <= 4096 and T >= 2 up to m = 1024, T = 1
// above; hop even; geo: the launch geometry of kernels/stft_vmem.py
// `stft_geometry`; lay: its shared memory, kernels/stft_vmem.py
// `stft_layout`. Returns a cudaError_t.
extern "C" int fftlab_stft_frames(const float* x, long long n, const float* win, const void* tw,
                                  const void* utw, float* yr, float* yi, long long n_frames,
                                  int hop, int log_m, int log_t, int bins, Geometry geo,
                                  StftLayout lay, void* stream) {
  const int m = 1 << log_m;
  const bool rows = log_m > 10;  // one frame per block, the row layout
  const long long blocks = (n_frames + (1LL << log_t) - 1) >> log_t;
  if (log_m < 6 || log_m > 13 || log_t < 0 || rows != (log_t == 0) || (m << log_t) > 16 * 512 ||
      (!rows && (m << log_t) > 4096) || n < 1 || n_frames < 1 || blocks > INT_MAX || hop < 2 ||
      (hop & 1) || hop > (1 << 24) || (bins != m + 1 && bins != 2 * m) ||
      (reinterpret_cast<uintptr_t>(x) & 7) || (reinterpret_cast<uintptr_t>(win) & 7)) {
    return cudaErrorInvalidValue;
  }
  const int log_pad = rows ? 0 : 4;
  if (geo.threads != (m << log_t) / kP || geo.threads % 32 != 0 || geo.log_pad != log_pad ||
      geo.log_last != (log_m & 3) ||
      geo.stride < (rows ? m : m + ((m - 1) >> log_pad) + 1) ||
      geo.smem > kMaxSmem || !valid_layout(lay, m, hop, 1 << log_t, geo.stride, bins, geo.smem)) {
    return cudaErrorInvalidValue;
  }
  auto go = [&](auto launch) {
    return launch(static_cast<unsigned>(blocks), geo, stream, x, n, win, tw, utw, yr, yi,
                  n_frames, hop, log_t, bins, lay);
  };
  if (rows) {
    return dispatch<11, 13>(log_m, [&](auto c) {
      return go(launch_stft<decltype(c)::value, 0>);
    });
  }
  return dispatch<6, 10>(log_m, [&](auto c) { return go(launch_stft<decltype(c)::value, 4>); });
}
