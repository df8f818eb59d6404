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
// usable frames of 595 samples on average.  Its bytes (x, positions and
// f0 read, the output written) are ~1.2 MB.  The cosines and sines are
// taken in float64 (the function's arguments are float32; see
// ops/stonemask.py), so the float64 pipe sets the pace (4-6% of the
// operations bound, counted in float32: PERF.md).
//
// Design (simple first):
// - One warp a (row, frame), grid-stride over all warps; as many warps a
//   block (at most 16) as their buffers fit in the shared memory a block
//   may hold: 2 max_len floats a warp, the windowed samples xm and xd.
//   Frames outside the test write 0 and cost nothing more.
// - The window is computed once a frame, lane l taking i = l, l + 32,
//   ... into xm; its centred difference (zero outside the window, so
//   halved at both edges) from there into xd; then both times the
//   edge-clamped samples, read coalesced.  Both passes read xm and xd
//   from shared memory.
// - Each pass: lane l sums its terms i = l, l + 32, ... of the bins' 4
//   dots in registers (the phase omega_h i a float32 product, its cos /
//   sin in float64 rounded once), then an xor butterfly over the warp
//   leaves every lane the same sums, and every lane runs the harmonic
//   arithmetic in JAX's order.  A first pass that fails (t0 <= 0 or
//   t0 > 2 f0) skips the second: its frame keeps the input F0.
// - Built with -fmad=false (_cuda.SOURCE_FLAGS), with IEEE division and
//   square root: every product and quotient rounds on its own, as the
//   plain version's tensor ops (and JAX's float32 ops) do, and the plain
//   version sums in this kernel's order (ops/refine.py: warp_sum over 32
//   lanes), so the two agree on the card.
// - A frame's result depends on its own inputs only, not on the other
//   frames of the launch.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxWarps = 16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr double kPi = 3.1415926535897932384;
// float32 constants as JAX's weak typing rounds the Python floats (the
// double, then the float).
constexpr float kTwoPiF = static_cast<float>(2.0 * kPi);
constexpr float kFourPiF = static_cast<float>(4.0 * kPi);
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

__device__ __forceinline__ int matlab_round(float v) {
  return static_cast<int>(truncf(v + (v > 0.0f ? 0.5f : -0.5f)));
}

// cos of the float32 ``a``, taken in float64 and rounded once.
__device__ __forceinline__ float cos_once(float a) {
  return static_cast<float>(cos(static_cast<double>(a)));
}

// One FixF0 pass (src/stonemask.cpp:96-118) of kHarm bins at F0 ``f`` over
// the warp's windowed samples xm, xd (win_len each); every lane returns
// the same value.
template <int kHarm>
__device__ float fix_f0(const float* xm, const float* xd, int win_len,
                        float f, float fftf, float fs, int lane) {
  const int half = static_cast<int>(fftf / 2.0f);
  const float step = __fdiv_rn(kTwoPiF, fftf);
  int index[kHarm];
  float omega[kHarm];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    int k = matlab_round(__fdiv_rn(f * fftf, fs) * static_cast<float>(h + 1));
    k = k < half ? k : half;
    index[h] = k > 0 ? k : 0;
    omega[h] = step * static_cast<float>(index[h]);
  }
  // acc[h]: cos . xm, sin . xm, cos . xd, sin . xd.
  float acc[kHarm][4];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.0f;
  }
  for (int i = lane; i < win_len; i += 32) {
    const float m = xm[i], d = xd[i];
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int h = 0; h < kHarm; ++h) {
      double s, c;
      sincos(static_cast<double>(omega[h] * fi), &s, &c);
      const float cf = static_cast<float>(c), sf = static_cast<float>(s);
      acc[h][0] += cf * m;
      acc[h][1] += sf * m;
      acc[h][2] += cf * d;
      acc[h][3] += sf * d;
    }
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
    const float m_re = acc[h][0], m_im = -acc[h][1];
    const float d_re = acc[h][2], d_im = -acc[h][3];
    const float ps = m_re * m_re + m_im * m_im;
    const float numer = m_re * d_im - m_im * d_re;
    const float inst =
        ps == 0.0f ? 0.0f
                   : __fdiv_rn(static_cast<float>(index[h]) * fs, fftf)
                         + __fdiv_rn(__fdiv_rn(numer, ps) * fs, kTwoPiF);
    const float amp = __fsqrt_rn(ps);
    num += amp * inst;
    den += amp * static_cast<float>(h + 1);
  }
  return __fdiv_rn(num, den + kSafeGuard);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    stonemask_kernel(Args p) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xm = smem + 2 * p.max_len * warp;
  float* xd = xm + p.max_len;
  const float fs = p.fs;
  const float top = __fdiv_rn(fs, 12.0f);
  const long long items = static_cast<long long>(p.B) * p.F;
  for (long long item = static_cast<long long>(blockIdx.x) * warps + warp;
       item < items; item += static_cast<long long>(gridDim.x) * warps) {
    const float f0 = p.f0[item];
    if (!(f0 > kFloorF0 && f0 <= top)) {
      if (lane == 0) p.out[item] = 0.0f;
      continue;
    }
    const float pos = p.positions[item];
    const float* xrow = p.x + (item / p.F) * p.L;
    const int hw = static_cast<int>(__fdiv_rn(1.5f * fs, f0) + 1.0f);
    const int win_len = 2 * hw + 1;
    if (win_len > p.max_len) {
      // Past the buffer: the wrapper's max_len check (window_bound)
      // rules it out at every integer rate up to 400 kHz.
      if (lane == 0) p.out[item] = __int_as_float(0x7fc00000);
      continue;
    }
    const float wlt = __fdiv_rn(static_cast<float>(win_len), fs);
    const int idx0 =
        matlab_round((pos - __fdiv_rn(static_cast<float>(hw), fs)) * fs);
    __syncwarp();  // the previous frame's buffers are read
    for (int i = lane; i < win_len; i += 32) {
      const float tmp =
          __fdiv_rn(static_cast<float>(idx0 + i) - 1.0f, fs) - pos;
      const float c1 = cos_once(__fdiv_rn(kTwoPiF * tmp, wlt));
      const float c2 = cos_once(__fdiv_rn(kFourPiF * tmp, wlt));
      xm[i] = (k042 + 0.5f * c1) + k008 * c2;
    }
    __syncwarp();
    for (int i = lane; i < win_len; i += 32) {
      const float nxt = i + 1 < win_len ? xm[i + 1] : 0.0f;
      const float prv = i > 0 ? xm[i - 1] : 0.0f;
      xd[i] = -(nxt - prv) * 0.5f;
    }
    __syncwarp();
    for (int i = lane; i < win_len; i += 32) {
      int k = idx0 - 1 + i;
      k = k < 0 ? 0 : (k > p.L - 1 ? p.L - 1 : k);
      const float s = xrow[k];
      xm[i] = s * xm[i];
      xd[i] = s * xd[i];
    }
    __syncwarp();
    // JAX's exp2(e) = exp(ln 2 e): the float32 product, its exp in
    // float64 rounded once.
    const int e = 2 + (31 - __clz(win_len));
    const float fftf = static_cast<float>(
        exp(static_cast<double>(kLn2F * static_cast<float>(e))));
    const float t0 = fix_f0<2>(xm, xd, win_len, f0, fftf, fs, lane);
    float refined = 0.0f;
    if (!(t0 <= 0.0f || t0 > f0 * 2.0f)) {
      refined = fix_f0<6>(xm, xd, win_len, t0, fftf, fs, lane);
    }
    // Keep the input where the correction is over-large
    // (src/stonemask.cpp:185-208).
    const bool over = fabsf(refined - f0) > f0 * k02;
    if (lane == 0) p.out[item] = over ? f0 : refined;
  }
}

// Per device, once: the SM count and the most dynamic shared memory a
// block may opt in to (the kernel's limit raised to it).  0 until then.
std::atomic<int> sms_of[kMaxDevices];
std::atomic<int> smem_most_of[kMaxDevices];

cudaError_t prepare(int dev, int* sms, int* smem_most) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sms_of[dev].load(std::memory_order_relaxed);
  *smem_most = smem_most_of[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  cudaError_t err = cudaDeviceGetAttribute(
      smem_most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(stonemask_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_most);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    smem_most_of[dev].store(*smem_most, std::memory_order_relaxed);
    sms_of[dev].store(*sms, std::memory_order_relaxed);
  }
  return err;
}

}  // namespace

// x (B, L), positions (B, F), f0 (B, F), out (B, F), float32, contiguous;
// max_len >= the longest window of a usable frame (ops/stonemask.py:
// window_bound).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments out of range or a warp's buffers
// past the shared memory a block may hold).
extern "C" int stonemask_refine(const void* x, const void* positions,
                                const void* f0, void* out, int B, int L,
                                int F, int max_len, float fs, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (L <= 0 || max_len < 3 || !(fs > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, smem_most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, &sms, &smem_most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_warp = 8LL * max_len;
  long long warps = smem_most / per_warp;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int threads = static_cast<int>(32 * warps);
  const size_t smem = static_cast<size_t>(per_warp * warps);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stonemask_kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(B) * F;
  long long blocks = (items + warps - 1) / warps;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > most) blocks = most;
  Args a{static_cast<const float*>(x), static_cast<const float*>(positions),
         static_cast<const float*>(f0), static_cast<float*>(out), B, L, F,
         max_len, fs};
  stonemask_kernel<<<static_cast<int>(blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
