// StoneMask's float32 refinement: every frame's refined F0 from the 2,
// then 6 harmonic DFT bins of one contiguous window, each bin a direct
// cos / sin dot (ops/stonemask.py states the function;
// stonemask_refine_plain is its plain version).  The frame test (40 Hz <
// f0 <= fs / 12) and the 20% rule after the refinement run here too, so
// that the model's float32 StoneMask is this one launch.
//
// Replaces: no Pallas kernel, but the JAX package's float32 branch of
// StoneMask, a JAX/XLA stage: _refine_direct (world_tpu/models/
// stonemask.py:110-168) under vmap over the frames (:193-211), which the
// port ran as ~360 eager ops a Dio step: the reference's float64
// formulation with a batched rfft per fft size, over frames picked out on
// the host.
//
// Bound on the H100: operations.  A frame of win_len samples (up to
// 3,603 at 48 kHz) costs win_len x (~13 float32 operations and two
// cosines for the window, then for each of 2 + 6 bins a phase product,
// a sincos and 4 multiply-adds); a 16-row 22.05 kHz Dio step has 1,856
// usable frames of 595 samples on average, ~8.8 M (bin, sample) terms.
// Its bytes (x, positions and f0 read, the output written) are ~1.2 MB.
// The cosines and sines are taken in float64 (the function's arguments
// are float32; see ops/stonemask.py): ~25 float64 multiply-adds and 3
// conversions each, and the conversions run at a quarter of the float64
// rate (16 an SM a clock), so the float64 and conversion pipes set the
// pace: counted so, a 22.05 kHz step needs ~0.03 ms of them.
//
// Design:
// - One warp a (row, frame), kWarps warps a block, kBlocksPerSm blocks an
//   SM: 16 resident warps an SM under the 128 registers a thread that
//   __launch_bounds__ then allows (122 used, no spills), and nothing in
//   shared memory.  More warps were timed slower (20, 24 and 32 an SM
//   under 96, 80 and 64 registers; PERF.md §6): each warp's six cos /
//   sin chains in flight need the registers more than the SM needs more
//   warps.  The grid holds a warp for every frame up to kMaxBlocks
//   blocks (the block scheduler balancing the frames' lengths),
//   grid-stride past that.  Frames outside the test write 0 and cost
//   nothing more.
// - Each pass (2 bins at f0, then 6 at t0) walks the window in chunks of
//   32 samples, lane l taking i = 32 k + l: the window w[i] one chunk
//   ahead, so that at chunk k a lane holds w of chunks k and k + 1;
//   w[i - 1] and w[i + 1] by shuffles from the lanes beside it, lane 0's
//   from the previous chunk's lane 31 (carried in a register), lane 31's
//   from the next chunk's lane 0.  So each window value is computed once
//   a pass, and w is zero outside the window (its difference halved at
//   both edges).  Then the edge-clamped sample, read coalesced, and the
//   bins' 4 dots in registers: the phase omega_h i a float32 product, its
//   cos / sin in float64 rounded once.  The second pass computes the
//   window again; it is a pure function of (frame, i), so it sees the
//   first pass's bits.
// - A chunk runs without a branch (the lanes past the window in the last
//   chunk add zeros; their window values are dropped), and the cos / sin
//   are the kernel's own (sincos_once: no slow path, so no branch), so
//   that the compiler interleaves a chunk's cos / sin chains.  CUDA's
//   sincos branches to its slow path on every call, which kept one chain
//   in flight a warp (PERF.md §6).
// - An xor butterfly over the warp leaves every lane the pass's sums, and
//   every lane runs the harmonic arithmetic in JAX's order.  A first pass
//   that fails (t0 <= 0 or t0 > 2 f0) skips the second: its frame keeps
//   the input F0.
// - Built with -fmad=false (_cuda.SOURCE_FLAGS), with IEEE division and
//   square root: every product and quotient rounds on its own, as the
//   plain version's tensor ops (and JAX's float32 ops) do, and the plain
//   version sums in this kernel's order (ops/refine.py: warp_sum over 32
//   lanes: lane l adds i = l, l + 32, ..., then the butterfly), so the
//   two agree on the card but where a float64 cos / sin of the kernel and
//   of torch round to different float32s.
// - A frame's result depends on its own inputs only, not on the other
//   frames of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBlocks = 1 << 16;
// Longest window the kernel takes: its sample indices as float32 are
// exact below 2^24 (ops/stonemask.py: MAX_LEN).
constexpr int kMaxLen = 1 << 24;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr double kPi = 3.1415926535897932384;
// float32 constants as JAX's weak typing rounds the Python floats (the
// double, then the float).
constexpr float kTwoPiF = static_cast<float>(2.0 * kPi);
constexpr float kLn2F = static_cast<float>(0.69314718055994530942);
constexpr float kFloorF0 = 40.0f;
constexpr float k042 = static_cast<float>(0.42);
constexpr float k008 = static_cast<float>(0.08);
constexpr float k02 = static_cast<float>(0.2);
constexpr float kSafeGuard = static_cast<float>(1e-12);

struct Args {
  const float* x;          // (B, L)
  const float* positions;  // (B, F) seconds
  const float* f0;         // (B, F)
  float* out;              // (B, F)
  int B, L, F, max_len;
  float fs;
};

// What a pass needs of its frame.
struct Frame {
  const float* xrow;  // the row's L samples
  int L, win_len, idx0;
  float fs, pos, wlt;
};

__device__ __forceinline__ int matlab_round(float v) {
  return static_cast<int>(truncf(v + (v > 0.0f ? 0.5f : -0.5f)));
}

// The kernel's float64 cos and sin, each rounded once to float32, for a
// float32 argument of at most 400 radians: there the quadrant q (a 2 / pi
// to the nearest integer) is below 256, so that q kPio2Hi (45 significant
// bits) and a - q kPio2Hi are exact.  The arguments stay well inside it.
// A phase omega_h i of a frame's own sample is at most (2 pi 6 f / fs +
// pi / fft) 2 hw <= 76 pi with f <= 2 f0 (the second pass's test) and f0
// <= fs / 12; the lanes past the window in its last chunk reach ~105 pi,
// and add zeros.  A window angle (twice 2 pi tmp / wlt) stays below ~70
// wherever idx0 fits an int (|tmp| <= (hw + 200) / fs).
constexpr double kTwoOverPi = 6.36619772367581382433e-01;
// 1.5 2^52: a double of this size has no fraction bits, so adding it
// rounds to an integer, which the low word then holds.
constexpr double kRoundInt = 6755399441055744.0;
constexpr double kPio2Hi = 1.57079632679489122649e+00;  // 0x1.921fb54442d00p0
constexpr double kPio2Lo = 5.39030285815811878790e-15;  // pi / 2 - kPio2Hi
// fdlibm's __kernel_sin and __kernel_cos on |r| <= pi / 4.
constexpr double kS1 = -1.66666666666666324348e-01;
constexpr double kS2 = 8.33333333332248946124e-03;
constexpr double kS3 = -1.98412698298579493134e-04;
constexpr double kS4 = 2.75573137070700676789e-06;
constexpr double kS5 = -2.50507602534068634195e-08;
constexpr double kS6 = 1.58969099521155010221e-10;
constexpr double kC1 = 4.16666666666666019037e-02;
constexpr double kC2 = -1.38888888888741095749e-03;
constexpr double kC3 = 2.48015872894767294178e-05;
constexpr double kC4 = -2.75573143513906633035e-07;
constexpr double kC5 = 2.08757232129817482790e-09;
constexpr double kC6 = -1.13596475577881948265e-11;

// cos and sin of the float32 ``a``, each in float64 rounded once, without
// a branch: a two-constant Cody-Waite reduction to |r| <= pi / 4 (the
// quadrant by kRoundInt, which spares the conversion pipe, a quarter of
// the float64 rate, a rounding and a float64-to-int), fdlibm's polynomials
// (each multiply-add an fma(): -fmad=false contracts nothing), the
// quadrant's signs and swap.  NaN and infinities give NaN.
__device__ __forceinline__ void sincos_once(float a, float* s, float* c) {
  const double x = static_cast<double>(a);
  const double t = fma(x, kTwoOverPi, kRoundInt);
  const double q = t - kRoundInt;
  const double r = fma(-q, kPio2Lo, fma(-q, kPio2Hi, x));
  const double z = r * r;
  const double ps =
      fma(z, fma(z, fma(z, fma(z, fma(z, kS6, kS5), kS4), kS3), kS2), kS1);
  const double sr = fma(z * r, ps, r);
  const double pc =
      fma(z, fma(z, fma(z, fma(z, fma(z, kC6, kC5), kC4), kC3), kC2), kC1);
  const double hz = 0.5 * z;
  const double w = 1.0 - hz;
  const double cr = w + (((1.0 - w) - hz) + z * (z * pc));
  const int n = __double2loint(t) & 3;
  const float sv = static_cast<float>((n & 1) ? cr : sr);
  const float cv = static_cast<float>((n & 1) ? sr : cr);
  *s = (n & 2) ? -sv : sv;
  *c = ((n + 1) & 2) ? -cv : cv;
}

// cos of the float32 ``a``, taken in float64 and rounded once.
__device__ __forceinline__ float cos_once(float a) {
  float s, c;
  sincos_once(a, &s, &c);
  return c;
}

// The Blackman window w[i], zero outside [0, win_len).  Its cosines are
// taken for every i (a value outside the window is dropped, whatever it
// is), so that a chunk runs without a branch.  The 4 pi angle is twice
// the 2 pi one, bit for bit (4 pi in float32 is twice 2 pi, and a doubled
// product or quotient rounds as its half does), so it costs no division.
__device__ __forceinline__ float window(const Frame& fr, int i) {
  const float tmp =
      __fdiv_rn(static_cast<float>(fr.idx0 + i) - 1.0f, fr.fs) - fr.pos;
  const float a = __fdiv_rn(kTwoPiF * tmp, fr.wlt);
  const float c1 = cos_once(a);
  const float c2 = cos_once(2.0f * a);
  const float w = (k042 + 0.5f * c1) + k008 * c2;
  return i < fr.win_len ? w : 0.0f;
}

// The bin index of harmonic ``h`` (from 1) at F0 ``f``.
__device__ __forceinline__ int bin_index(int h, float f, float fftf,
                                         float fs, int half) {
  const int k =
      matlab_round(__fdiv_rn(f * fftf, fs) * static_cast<float>(h));
  return k < half ? (k > 0 ? k : 0) : half;
}

// One FixF0 pass (src/stonemask.cpp:96-118) of kHarm bins at F0 ``f``
// over the frame's windowed samples; every lane returns the same value.
template <int kHarm>
__device__ float fix_f0(const Frame& fr, float f, float fftf, int lane) {
  const float fs = fr.fs;
  const int half = static_cast<int>(fftf / 2.0f);
  const float step = __fdiv_rn(kTwoPiF, fftf);
  float omega[kHarm];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    omega[h] =
        step * static_cast<float>(bin_index(h + 1, f, fftf, fs, half));
  }
  // acc[h]: cos . xm, sin . xm, cos . xd, sin . xd, lane l's terms i = l,
  // l + 32, ... in that order; the lanes of the last chunk past the window
  // add zeros.
  float acc[kHarm][4];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.0f;
  }
  const int chunks = (fr.win_len + 31) >> 5;
  float w = window(fr, lane), w_next = window(fr, lane + 32);
  float carry = 0.0f;  // w[32 k - 1]: the previous chunk's lane 31
  for (int k = 0; k < chunks; ++k) {
    const int i = (k << 5) + lane;
    float prv = __shfl_up_sync(kFullMask, w, 1);
    float nxt = __shfl_down_sync(kFullMask, w, 1);
    const float head = __shfl_sync(kFullMask, w_next, 0);
    const float tail = __shfl_sync(kFullMask, w, 31);
    if (lane == 0) prv = carry;
    if (lane == 31) nxt = head;
    carry = tail;
    int j = fr.idx0 - 1 + i;
    j = j < 0 ? 0 : (j > fr.L - 1 ? fr.L - 1 : j);
    const float xj = fr.xrow[j];
    const float s = i < fr.win_len ? xj : 0.0f;
    const float m = s * w, d = s * (-(nxt - prv) * 0.5f);
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int h = 0; h < kHarm; ++h) {
      float sf, cf;
      sincos_once(omega[h] * fi, &sf, &cf);
      acc[h][0] += cf * m;
      acc[h][1] += sf * m;
      acc[h][2] += cf * d;
      acc[h][3] += sf * d;
    }
    w = w_next;
    w_next = window(fr, i + 64);
  }
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[h][v] += __shfl_xor_sync(kFullMask, acc[h][v], off);
      }
    }
  }
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    const float index =
        static_cast<float>(bin_index(h + 1, f, fftf, fs, half));
    const float m_re = acc[h][0], m_im = -acc[h][1];
    const float d_re = acc[h][2], d_im = -acc[h][3];
    const float ps = m_re * m_re + m_im * m_im;
    const float numer = m_re * d_im - m_im * d_re;
    const float inst =
        ps == 0.0f ? 0.0f
                   : __fdiv_rn(index * fs, fftf)
                         + __fdiv_rn(__fdiv_rn(numer, ps) * fs, kTwoPiF);
    const float amp = __fsqrt_rn(ps);
    num += amp * inst;
    den += amp * static_cast<float>(h + 1);
  }
  return __fdiv_rn(num, den + kSafeGuard);
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
    stonemask_kernel(Args p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float fs = p.fs;
  const float top = __fdiv_rn(fs, 12.0f);
  const long long items = static_cast<long long>(p.B) * p.F;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
       item < items; item += static_cast<long long>(gridDim.x) * kWarps) {
    const float f0 = p.f0[item];
    if (!(f0 > kFloorF0 && f0 <= top)) {
      if (lane == 0) p.out[item] = 0.0f;
      continue;
    }
    const int hw = static_cast<int>(__fdiv_rn(1.5f * fs, f0) + 1.0f);
    Frame fr;
    fr.win_len = 2 * hw + 1;
    if (fr.win_len > p.max_len) {
      // Past the caller's bound: the wrapper's max_len check
      // (window_bound) rules it out at every integer rate up to 400 kHz.
      if (lane == 0) p.out[item] = __int_as_float(0x7fc00000);
      continue;
    }
    fr.xrow = p.x + (item / p.F) * p.L;
    fr.L = p.L;
    fr.fs = fs;
    fr.pos = p.positions[item];
    fr.wlt = __fdiv_rn(static_cast<float>(fr.win_len), fs);
    fr.idx0 =
        matlab_round((fr.pos - __fdiv_rn(static_cast<float>(hw), fs)) * fs);
    // JAX's exp2(e) = exp(ln 2 e): the float32 product, its exp in
    // float64 rounded once.
    const int e = 2 + (31 - __clz(fr.win_len));
    const float fftf = static_cast<float>(
        exp(static_cast<double>(kLn2F * static_cast<float>(e))));
    const float t0 = fix_f0<2>(fr, f0, fftf, lane);
    float refined = 0.0f;
    if (!(t0 <= 0.0f || t0 > f0 * 2.0f)) {
      refined = fix_f0<6>(fr, t0, fftf, lane);
    }
    // Keep the input where the correction is over-large
    // (src/stonemask.cpp:185-208).
    const bool over = fabsf(refined - f0) > f0 * k02;
    if (lane == 0) p.out[item] = over ? f0 : refined;
  }
}

long long grid_of(long long items) {
  const long long blocks = (items + kWarps - 1) / kWarps;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// x (B, L), positions (B, F), f0 (B, F), out (B, F), float32, contiguous;
// max_len >= the longest window of a usable frame (ops/stonemask.py:
// window_bound; a frame whose window is longer writes NaN).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments out of
// range).
extern "C" int stonemask_refine(const void* x, const void* positions,
                                const void* f0, void* out, int B, int L,
                                int F, int max_len, float fs, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (L <= 0 || max_len < 3 || max_len > kMaxLen || !(fs > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(x), static_cast<const float*>(positions),
         static_cast<const float*>(f0), static_cast<float*>(out), B, L, F,
         max_len, fs};
  const long long blocks = grid_of(static_cast<long long>(B) * F);
  stonemask_kernel<<<static_cast<int>(blocks), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape for B x F frames on the current device: warps a
// block, resident blocks an SM (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SM count and the
// grid's blocks.  Returns a cudaError_t.
extern "C" int stonemask_launch_shape(int B, int F, int* warps, int* per_sm,
                                      int* sms, int* blocks) {
  *warps = kWarps;
  *blocks = static_cast<int>(grid_of(static_cast<long long>(B) * F));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, stonemask_kernel, kWarps * 32, 0);
  }
  return static_cast<int>(err);
}
