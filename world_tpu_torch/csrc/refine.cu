// Harvest's float32 instantaneous-frequency refinement: every (frame,
// candidate) pair's refined F0 and score from its <= 6 harmonic DFT bins,
// each a direct dot over a frame-centred window (ops/refine.py states the
// function; harvest_refine_plain is its plain version).
//
// Replaces: no Pallas kernel, but the JAX package's float32 branch of
// Harvest's refinement, a JAX/XLA stage: _refine_frame_direct
// (world_tpu/models/harvest.py:265-435) under _refine_all's slot-chunk
// while-loops (:487-594).  The port ran the float64 formulation there
// (bucketed full FFTs, ~1,000 torch ops a step, host syncs); this kernel
// is the whole stage in one launch.
//
// Bound on the H100: operations.  Each term (pair, j) of a pair's window
// costs ~80 float32 operations (the window, its difference, four folds
// and 6 harmonics x 4 dot multiply-adds); a 16-row 22.05 kHz step has
// ~13.6 M terms (the sum over its ~221,000 usable pairs of hw + 1), so
// ~0.016 ms at 67 TFLOP/s.  Its bytes (cands in, two outputs out, y) are
// ~16 MB, ~0.005 ms at 3.35 TB/s.
//
// Design (simple first):
// - Each warp walks (row, frame) items, grid-stride over all warps, as
//   many blocks of 8 warps as fit the card at once (4 an SM under the
//   register cap below, where 80 registers a thread would hold 3).
//   A block stages the phase table (cos / sin of 2 pi k / 2^log2_max,
//   float32 rounded from float64; 8 KB at the default floor) in shared
//   memory once; a warp stages its frame's 2 hw_max + 1 edge-clamped
//   samples once, and every candidate of the frame reads its window from
//   there.  No block barrier past the table: a frame's 0-35 usable pairs
//   keep its warp alone busy, where a block a frame with a warp a pair
//   leaves warps idle at the frame's barrier.
// - The warp ballots its frame's slots 32 at a time and takes the usable
//   ones (cands > 0) in slot order, so the ~70 empty slots of 105 cost a
//   store of zeros.
// - A pair's lanes stride j = 0..min(hw, hw_max): first the window and
//   its mirror (cos / sin(2 pi j / win_len) in float64, rounded once,
//   into the warp's shared buffer), then the difference window, the four
//   folds x(j) +- x(-j) and the 24 dot partials in registers, the DFT's
//   phase (index j) mod fft read from the table.  A full-mask xor-shuffle
//   tree sums the partials in a fixed order; the harmonic arithmetic then
//   runs in JAX's order of operations and lane 0 writes both outputs.
// - Built with -fmad=false (_cuda.SOURCE_FLAGS): every multiply and add
//   rounds on its own, as the plain version's tensor ops do, and the plain
//   version sums in this kernel's order (ops/refine.py: warp_sum), so the
//   two agree bit for bit but where a float64 cosine rounds otherwise on
//   the host.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // caps the registers at 64 a thread
constexpr int kHarm = 6;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr double kTwoPi = 2.0 * 3.1415926535897932384;
constexpr float kTwoPiF = static_cast<float>(kTwoPi);
// hw above this (an f0 below 1.5 fs / 2^24) is held here, so that
// 2 hw + 1 stays an int.
constexpr float kMostHw = 16777216.0f;

struct Args {
  const float* y;          // (B, Ly)
  const float* positions;  // (F,) seconds
  const float* cands;      // (B, F, M)
  const float* table;      // (2, 2^log2_max): cos, then sin
  float* refined;          // (B, F, M)
  float* scores;           // (B, F, M)
  int B, Ly, F, M, hw_max, log2_max;
  float fs, f0_floor, f0_ceil;
};

__device__ __forceinline__ int matlab_round(float x) {
  return static_cast<int>(truncf(x + (x > 0.0f ? 0.5f : -0.5f)));
}

__device__ __forceinline__ float blackman(float c2) {
  return (0.42f + 0.5f * c2) + 0.08f * (2.0f * c2 * c2 - 1.0f);
}

// cos and sin of 2 pi num / den, taken in float64 and rounded once.
__device__ __forceinline__ void turn(int num, int den, float* c, float* s) {
  double sd, cd;
  sincos(static_cast<double>(num) / static_cast<double>(den) * kTwoPi, &sd,
         &cd);
  *c = static_cast<float>(cd);
  *s = static_cast<float>(sd);
}

// One pair on one warp (every lane calls it); lane 0 writes the outputs.
__device__ void refine_pair(const Args& p, float f0, int c0, float pos,
                            const float* seg, const float* tab_c,
                            const float* tab_s, float* w_p, float* w_m,
                            int lane, float* out_r, float* out_s) {
  const float fs = p.fs;
  const int hw_max = p.hw_max;
  const float hw_f = 1.5f * fs / f0 + 1.0f;
  const int hw = hw_f < kMostHw ? static_cast<int>(hw_f)
                                : static_cast<int>(kMostHw);
  const int jmax = hw < hw_max ? hw : hw_max;
  const int win_len = 2 * hw + 1;
  const float wlt = static_cast<float>(win_len) / fs;
  const float t0 = static_cast<float>(c0 - 1) / fs - pos;
  const float a = kTwoPiF * t0 / wlt;
  double sa_d, ca_d;
  sincos(static_cast<double>(a), &sa_d, &ca_d);
  const float ca = static_cast<float>(ca_d), sa = static_cast<float>(sa_d);

  // The window and its mirror, w(j) and w(-j), zero past jmax.
  for (int j = lane; j <= jmax; j += 32) {
    float cj, sj;
    turn(j, win_len, &cj, &sj);
    w_p[j] = blackman(ca * cj - sa * sj);
    w_m[j] = blackman(ca * cj + sa * sj);
  }
  if (lane == 0) {
    w_p[jmax + 1] = 0.0f;
    w_m[jmax + 1] = 0.0f;
  }
  __syncwarp();

  const int log2 = 2 + (31 - __clz(win_len));
  const int fft = 1 << log2;
  const float fft_f = static_cast<float>(fft);
  const int shift = p.log2_max - log2;  // < 0: past the table (hw > hw_max)
  const float n_f = fs / 2.0f / f0;
  const int n_harm = n_f < 6.0f ? static_cast<int>(n_f) : kHarm;
  int index[kHarm];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    int i = matlab_round(f0 * fft_f / fs * static_cast<float>(h + 1));
    i = i < 0 ? 0 : i;
    index[h] = i < fft / 2 ? i : fft / 2;
  }

  // acc[h]: cos . x_m even, sin . x_m odd, cos . x_d even, sin . x_d odd.
  float acc[kHarm][4];
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.0f;
  }
  for (int j = lane; j <= jmax; j += 32) {
    const float nxt_p = w_p[j + 1];
    const float prv_p = j > 0 ? w_p[j - 1] : w_m[1];
    const float nxt_m = j > 0 ? w_m[j - 1] : w_p[1];
    const float prv_m = w_m[j + 1];
    const float dw_p = -(nxt_p - prv_p) * 0.5f;
    const float dw_m = -(nxt_m - prv_m) * 0.5f;
    const float sp = seg[hw_max + j];
    const float sm = seg[hw_max - j];
    const float pm = sp * w_p[j];
    const float mm = j > 0 ? sm * w_m[j] : 0.0f;
    const float pd = sp * dw_p;
    const float md = j > 0 ? sm * dw_m : 0.0f;
    const float xm_e = pm + mm, xm_o = pm - mm;
    const float xd_e = pd + md, xd_o = pd - md;
#pragma unroll
    for (int h = 0; h < kHarm; ++h) {
      const int k = (index[h] * j) & (fft - 1);
      float c, s;
      if (shift >= 0) {
        c = tab_c[k << shift];
        s = tab_s[k << shift];
      } else {
        turn(k, fft, &c, &s);
      }
      acc[h][0] += c * xm_e;
      acc[h][1] += s * xm_o;
      acc[h][2] += c * xd_e;
      acc[h][3] += s * xd_o;
    }
  }
  __syncwarp();  // the buffer is free for the warp's next pair
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

  float num = 0.0f, den = 0.0f, dev = 0.0f;
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
    const float main_re = acc[h][0], main_im = -acc[h][1];
    const float diff_re = acc[h][2], diff_im = -acc[h][3];
    const float power = main_re * main_re + main_im * main_im;
    const float numer = main_re * diff_im - main_im * diff_re;
    const float harm = static_cast<float>(h + 1);
    const float inst =
        power == 0.0f ? 0.0f
                      : static_cast<float>(index[h]) * fs / fft_f
                            + numer / power * fs / kTwoPiF;
    const bool active = h < n_harm;
    const float amp = active ? sqrtf(power) : 0.0f;
    num += amp * inst * (active ? 1.0f : 0.0f);
    den += amp * harm;
    dev += active ? fabsf((inst / harm - f0) / f0) : 0.0f;
  }
  const float refined = num / (den + 1e-12f);
  const float score =
      1.0f / (dev / static_cast<float>(n_harm > 1 ? n_harm : 1) + 1e-12f);
  const bool ok =
      refined >= p.f0_floor && refined <= p.f0_ceil && score >= 2.5f;
  if (lane == 0) {
    *out_r = ok ? refined : 0.0f;
    *out_s = ok ? score : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    refine_kernel(Args p) {
  extern __shared__ float smem[];
  const int tab_len = 1 << p.log2_max;
  const int hw_max = p.hw_max;
  const int seg_len = 2 * hw_max + 1;
  const int pitch = hw_max + 2;
  const int per_warp = seg_len + 2 * pitch;
  float* tab_c = smem;
  float* tab_s = tab_c + tab_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* seg = tab_s + tab_len + warp * per_warp;
  float* w_p = seg + seg_len;
  float* w_m = w_p + pitch;
  for (int i = threadIdx.x; i < tab_len; i += kThreads) {
    tab_c[i] = p.table[i];
    tab_s[i] = p.table[tab_len + i];
  }
  __syncthreads();
  const long long items = static_cast<long long>(p.B) * p.F;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
       item < items; item += static_cast<long long>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(item / p.F);
    const int f = static_cast<int>(item - static_cast<long long>(b) * p.F);
    const float* yrow = p.y + static_cast<long long>(b) * p.Ly;
    const float* crow = p.cands + item * p.M;
    float* rrow = p.refined + item * p.M;
    float* srow = p.scores + item * p.M;
    const float pos = p.positions[f];
    const int c0 = matlab_round(pos * p.fs + 0.001f);
    __syncwarp();
    for (int k = lane; k < seg_len; k += 32) {
      int i = c0 - 1 - hw_max + k;
      i = i < 0 ? 0 : (i > p.Ly - 1 ? p.Ly - 1 : i);
      seg[k] = yrow[i];
    }
    __syncwarp();
    for (int base = 0; base < p.M; base += 32) {
      const int s = base + lane;
      const float f0 = s < p.M ? crow[s] : 0.0f;
      const bool use = f0 > 0.0f;
      if (s < p.M && !use) {
        rrow[s] = 0.0f;
        srow[s] = 0.0f;
      }
      unsigned ballot = __ballot_sync(kFullMask, use);
      while (ballot) {
        const int l = __ffs(ballot) - 1;
        ballot &= ballot - 1;
        const float f0_l = __shfl_sync(kFullMask, f0, l);
        refine_pair(p, f0_l, c0, pos, seg, tab_c, tab_s, w_p, w_m, lane,
                    rrow + base + l, srow + base + l);
      }
    }
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
    err = cudaFuncSetAttribute(refine_kernel,
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

// y (B, Ly), positions (F,), cands (B, F, M), table (2, 2^log2_max) float32
// (ops/refine.py: phase_table), refined and scores (B, F, M) float32, all
// contiguous; 1 <= hw_max, log2_max = 2 + floor(log2(2 hw_max + 1)).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments out of range or shared memory past the device's limit).
extern "C" int harvest_refine(const void* y, const void* positions,
                              const void* cands, const void* table,
                              void* refined, void* scores, int B, int Ly,
                              int F, int M, int hw_max, int log2_max,
                              float fs, float f0_floor, float f0_ceil,
                              void* stream) {
  if (B <= 0 || F <= 0 || M <= 0) return 0;
  if (Ly <= 0 || hw_max < 1 || log2_max < 2 || log2_max > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, smem_most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, &sms, &smem_most);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The table, then each warp's samples and window buffers.
  const long long floats =
      2LL * (1LL << log2_max)
      + kWarps * ((2LL * hw_max + 1) + 2LL * (hw_max + 2));
  const long long smem = 4 * floats;
  if (smem > smem_most) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, refine_kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps_needed = static_cast<long long>(B) * F;
  const long long blocks_needed = (warps_needed + kWarps - 1) / kWarps;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > blocks_needed) blocks = blocks_needed;
  Args a{static_cast<const float*>(y), static_cast<const float*>(positions),
         static_cast<const float*>(cands), static_cast<const float*>(table),
         static_cast<float*>(refined), static_cast<float*>(scores), B, Ly, F,
         M, hw_max, log2_max, fs, f0_floor, f0_ceil};
  refine_kernel<<<static_cast<int>(blocks), kThreads,
                  static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
