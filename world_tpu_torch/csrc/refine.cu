// Harvest's float32 instantaneous-frequency refinement: every (frame,
// candidate) pair's refined F0 and score from its <= 6 harmonic DFT bins,
// each a direct dot over a frame-centred window (ops/refine.py states the
// function; harvest_refine_plain is its plain version).  And the pruning
// pass after it, RemoveUnreliableCandidates (harvest_remove_unreliable;
// its plain version is ops/refine.py: remove_unreliable_plain).
//
// Replaces: no Pallas kernel, but the JAX package's float32 branch of
// Harvest's refinement, a JAX/XLA stage: _refine_frame_direct
// (world_tpu/models/harvest.py:265-435) under _refine_all's slot-chunk
// while-loops (:487-594), and _remove_unreliable (:602-621), which the
// port ran as 37 eager ops over (B, F, M, M) distance tensors.
//
// harvest_refine.  Bound on the H100: operations.  Each term (pair, j) of
// a pair's window costs ~80 float32 operations (the window, its
// difference, four folds and 6 harmonics x 4 dot multiply-adds); a
// 16-row 22.05 kHz step has ~13.6 M terms (the sum over its ~221,000
// usable pairs of hw + 1), so ~0.016 ms at 67 TFLOP/s.  Its bytes (cands
// in, two outputs out, y) are ~16 MB, ~0.005 ms at 3.35 TB/s.  A pair has
// only ~61 terms on average, so what a pair costs besides its terms (the
// reduction of 24 dot partials, six harmonics' divisions and square
// roots, the float64 sincos of its window origin) weighs as much as the
// terms when a warp works one pair.
//
// Design:
// - Each warp walks (row, frame) items, grid-stride over all warps, as
//   many blocks of 8 warps as fit the card at once (3 an SM, under the
//   80-register cap that implies: 4 blocks' 64 registers spill, and were
//   timed slower).  A block stages the phase table (cos / sin of 2 pi k /
//   2^log2_max, float32 rounded from float64) once, as float2 pairs (one
//   load a harmonic; a pad slot every 16 entries and an xor swizzle,
//   against bank conflicts, were timed and were no faster: PERF.md §6).
//   A warp stages its frame's 2 hw_max + 1 edge-clamped samples once;
//   every candidate of the frame reads its window from there.
// - A group of 4 lanes works one pair, so a warp works 8 pairs at once:
//   one instruction runs 8 pairs' tails, and the dot partials meet in 2
//   shuffle levels (8, 16 and 32 lanes a pair were timed slower).  The
//   warp compacts its frame's usable slots (cands > 0) in slot order, 128
//   at a time, then sorts each 32 of them by window length (a bitonic
//   sort across the lanes) and hands them to the groups in that order, so
//   that the pairs of one round have windows of nearly one length and the
//   round's lanes stay busy.  Outputs land in their own slots; the empty
//   slots cost a store of zeros.
// - Lane l of a group takes j = l, l + 4, ...: the window and its mirror
//   at j + 4 one stride ahead, so that each window value is computed once
//   and its neighbours j +- 1 come from the next and the previous lane by
//   shuffles (the first lane's j - 1 is the last lane's value of the
//   stride before, the last lane's j + 1 the first lane's of the next).
//   cos / sin(2 pi j / win_len), float64 rounded once, come from the
//   window table, which follows the phase table in ``table`` and holds
//   every window length up to hw_max (a window past it takes a float64
//   sincos a term, which was timed slower for all).  Then the difference
//   window, the four folds x(j) +- x(-j) and the 24 dot partials in
//   registers, the DFT's phase (index j) mod fft read from the staged
//   table.  An xor-shuffle butterfly over the group sums the partials;
//   the harmonic arithmetic then runs in JAX's order of operations and
//   the group's first lane writes both outputs.
// - Tensor cores do not fit: every pair has its own window and its own
//   harmonic bins, so no operand is shared across pairs, and TF32 would
//   break the bit equality with the plain version (and its CPU parity
//   with JAX).
// - Built with -fmad=false (_cuda.SOURCE_FLAGS): every multiply and add
//   rounds on its own, as the plain version's tensor ops do, and the plain
//   version sums in this kernel's order (ops/refine.py: warp_sum over
//   LANES = kLanes lanes), so the two agree bit for bit but where a
//   float64 cosine rounds otherwise on the host.
//
// harvest_remove_unreliable.  Bound on the H100: bytes, two (B, F, M)
// inputs read once and two written (~21 MB, ~0.0063 ms, for a 16-row
// 22.05 kHz step).  A candidate a of an interior frame is zeroed (with its
// score) when min over the slots b of frames f - 1 and f + 1 of
// |a - b| / a exceeds 0.05 (in the tensors' type: 0.05f in float32), as
// the plain version's torch ops compute it; a NaN anywhere in the minimum
// keeps the candidate, as torch's and JAX's minimum propagate it.  One
// warp a (row, frame), grid-stride, loading 128 slots at a time with all
// their loads in flight: a frame with a nonzero slot compacts the nonzero
// values of frames f - 1 and f + 1 into a list in shared memory (by
// ballot), then takes its nonzero slots one at a time and tests 32 list
// entries at once, one a lane, stopping at the first chunk that holds
// one within the limit; a zero neighbour gives |a| / a, taken once; a
// frame without one copies its slots (the other layouts timed: PERF.md
// §6).  The test is "some |a - b| / a is not above 0.05", which does not
// depend on the order, so the outputs equal the plain version's.  It
// reads its inputs and writes new outputs: every frame's test sees the
// values before any was zeroed.  Templated
// on float and double (the float64 exact path runs the same pass).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;
constexpr int kLanes = 4;              // lanes a pair
constexpr int kGroups = 32 / kLanes;   // pairs a warp works at once
constexpr int kWindow = 128;           // slots a warp compacts at once
constexpr int kHarm = 6;
constexpr int kHeld = 4;  // 32-slot chunks a warp loads at once (remove)
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
  const float* table;      // (2, 2^log2_max): cos, then sin; then the
                           // window table
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

// The pair's window half-width int(1.5 fs / f0 + 1), held at kMostHw.
__device__ __forceinline__ int half_width(float fs, float f0) {
  const float hw_f = 1.5f * fs / f0 + 1.0f;
  return hw_f < kMostHw ? static_cast<int>(hw_f)
                        : static_cast<int>(kMostHw);
}

// The window w(j) and its mirror w(-j) (returned in *w_m); 0 past jmax.
// cos / sin(2 pi j / win_len) from the window table's row ``wrow``, or
// computed where the window is past the table (wrow null).
__device__ __forceinline__ float window_at(int j, int jmax,
                                           const float2* wrow, int win_len,
                                           float ca, float sa, float* w_m) {
  if (j > jmax) {
    *w_m = 0.0f;
    return 0.0f;
  }
  float cj, sj;
  if (wrow != nullptr) {
    const float2 cs = __ldg(wrow + j);
    cj = cs.x;
    sj = cs.y;
  } else {
    turn(j, win_len, &cj, &sj);
  }
  *w_m = blackman(ca * cj + sa * sj);
  return blackman(ca * cj - sa * sj);
}

// Ascending sort of one int a lane across the warp (bitonic).
__device__ __forceinline__ int sort32(int key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(kFullMask, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// One pair on each group of kLanes lanes (every lane of the warp calls
// it; ``have`` false for a group without a pair).  ``iters`` (the same on
// every lane) strides cover the longest window of the warp's pairs.  The
// group's first lane writes the outputs.
__device__ void refine_group(const Args& p, bool have, float f0, int c0,
                             float pos, const float* seg, const float2* tab,
                             const float2* wtab, int sub, int iters,
                             float* out_r, float* out_s) {
  const float fs = p.fs;
  const int hw_max = p.hw_max;
  const int hw = half_width(fs, f0);
  const int jmax = !have ? -1 : (hw < hw_max ? hw : hw_max);
  const int win_len = 2 * hw + 1;
  // Row hw of the window table: rows 1, 2, ... of hw + 1 entries each.
  const float2* wrow =
      hw <= hw_max ? wtab + (hw - 1) * (hw + 2) / 2 : nullptr;
  const float wlt = static_cast<float>(win_len) / fs;
  const float t0 = static_cast<float>(c0 - 1) / fs - pos;
  const float a = kTwoPiF * t0 / wlt;
  double sa_d, ca_d;
  sincos(static_cast<double>(a), &sa_d, &ca_d);
  const float ca = static_cast<float>(ca_d), sa = static_cast<float>(sa_d);

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
  float cur_m, prev_p = 0.0f, prev_m = 0.0f;
  float cur_p = window_at(sub, jmax, wrow, win_len, ca, sa, &cur_m);
  for (int t = 0; t < iters; ++t) {
    const int j = t * kLanes + sub;
    float nxt_m;
    const float nxt_p =
        window_at(j + kLanes, jmax, wrow, win_len, ca, sa, &nxt_m);
    // w(j + 1) from the next lane (the last lane: the first lane's next
    // stride); w(j - 1) from the previous lane (the first lane: the last
    // lane's previous stride).
    const float up_p = __shfl_sync(kFullMask, sub == 0 ? nxt_p : cur_p,
                                   sub + 1, kLanes);
    const float up_m = __shfl_sync(kFullMask, sub == 0 ? nxt_m : cur_m,
                                   sub + 1, kLanes);
    const float dn_p = __shfl_sync(
        kFullMask, sub == kLanes - 1 ? prev_p : cur_p, sub + kLanes - 1,
        kLanes);
    const float dn_m = __shfl_sync(
        kFullMask, sub == kLanes - 1 ? prev_m : cur_m, sub + kLanes - 1,
        kLanes);
    if (j <= jmax) {
      // The j = 0 neighbours cross the halves: w(-1) = w_m(1), and the
      // mirror's w_m(-1) = w_p(1).
      const float prv_p = j > 0 ? dn_p : up_m;
      const float nxt_mw = j > 0 ? dn_m : up_p;
      const float dw_p = -(up_p - prv_p) * 0.5f;
      const float dw_m = -(nxt_mw - up_m) * 0.5f;
      const float sp = seg[hw_max + j];
      const float sm = seg[hw_max - j];
      const float pm = sp * cur_p;
      const float mm = j > 0 ? sm * cur_m : 0.0f;
      const float pd = sp * dw_p;
      const float md = j > 0 ? sm * dw_m : 0.0f;
      const float xm_e = pm + mm, xm_o = pm - mm;
      const float xd_e = pd + md, xd_o = pd - md;
#pragma unroll
      for (int h = 0; h < kHarm; ++h) {
        const int k = (index[h] * j) & (fft - 1);
        float c, s;
        if (shift >= 0) {
          const float2 cs = tab[k << shift];
          c = cs.x;
          s = cs.y;
        } else {
          turn(k, fft, &c, &s);
        }
        acc[h][0] += c * xm_e;
        acc[h][1] += s * xm_o;
        acc[h][2] += c * xd_e;
        acc[h][3] += s * xd_o;
      }
    }
    prev_p = cur_p;
    prev_m = cur_m;
    cur_p = nxt_p;
    cur_m = nxt_m;
  }
#pragma unroll
  for (int h = 0; h < kHarm; ++h) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
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
  if (have && sub == 0) {
    *out_r = ok ? refined : 0.0f;
    *out_s = ok ? score : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    refine_kernel(Args p) {
  extern __shared__ float2 smem2[];
  const int tab_len = 1 << p.log2_max;
  const int hw_max = p.hw_max;
  const int seg_len = 2 * hw_max + 1;
  const int per_warp = seg_len + kWindow;
  float2* tab = smem2;
  const float2* wtab = reinterpret_cast<const float2*>(p.table + 2 * tab_len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1), group = lane / kLanes;
  float* seg = reinterpret_cast<float*>(tab + tab_len) + warp * per_warp;
  int* list = reinterpret_cast<int*>(seg + seg_len);
  for (int i = threadIdx.x; i < tab_len; i += kThreads) {
    tab[i] = make_float2(p.table[i], p.table[tab_len + i]);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
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
    for (int w0 = 0; w0 < p.M; w0 += kWindow) {
      const int w1 = w0 + kWindow < p.M ? w0 + kWindow : p.M;
      // The usable slots of [w0, w1) in slot order; zeros in the rest.
      int n = 0;
      for (int base = w0; base < w1; base += 32) {
        const int s = base + lane;
        const float f0 = s < w1 ? crow[s] : 0.0f;
        const bool use = f0 > 0.0f;
        if (s < w1 && !use) {
          rrow[s] = 0.0f;
          srow[s] = 0.0f;
        }
        const unsigned ballot = __ballot_sync(kFullMask, use);
        if (use) list[n + __popc(ballot & below)] = s;
        n += __popc(ballot);
      }
      __syncwarp();
      for (int c = 0; c < n; c += 32) {
        const int cnt = n - c < 32 ? n - c : 32;
        const bool valid = lane < cnt;
        const int slot = valid ? list[c + lane] : 0;
        const float f0 = valid ? crow[slot] : 0.0f;
        const int jmax_l = valid ? min(half_width(p.fs, f0), hw_max) : 0;
        const int key =
            sort32(valid ? (jmax_l << 5) | lane : INT_MAX, lane);
        for (int r0 = 0; r0 < cnt; r0 += kGroups) {
          const int at = r0 + group;
          const bool have = at < cnt;
          const int src = __shfl_sync(kFullMask, key, at & 31) & 31;
          const float f0_g = __shfl_sync(kFullMask, f0, src);
          const int slot_g = __shfl_sync(kFullMask, slot, src);
          const int jmax_g = __shfl_sync(kFullMask, jmax_l, src);
          const int longest = __reduce_max_sync(kFullMask, have ? jmax_g : 0);
          refine_group(p, have, have ? f0_g : p.f0_ceil, c0, pos, seg, tab,
                       wtab, sub, longest / kLanes + 1, rrow + slot_g,
                       srow + slot_g);
        }
      }
      __syncwarp();  // the list is free for the next slots
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

// ------------------------------------------- RemoveUnreliableCandidates

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }

__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

template <typename T>
__global__ void remove_kernel(const T* __restrict__ cands,
                              const T* __restrict__ scores,
                              T* __restrict__ out_c, T* __restrict__ out_s,
                              int B, int F, int M) {
  extern __shared__ unsigned char remove_smem[];
  const T limit = static_cast<T>(0.05);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // The warp's list of its frame's neighbours' nonzero values.
  T* list = reinterpret_cast<T*>(remove_smem) + 2LL * M * warp;
  const long long items = static_cast<long long>(B) * F;
  for (long long item = static_cast<long long>(blockIdx.x) * warps + warp;
       item < items; item += static_cast<long long>(gridDim.x) * warps) {
    const int f = static_cast<int>(item % F);
    const bool interior = f > 0 && f < F - 1;
    const T* row = cands + item * M;
    const T* srow = scores + item * M;
    // 128 slots of frame f at a time, their loads all in flight; the
    // list is built, once, when the first of them holds a slot to test
    // (an unvoiced frame only copies its slots).
    int n = 0;
    bool zero_seen = false, listed = false;
    for (int s0 = 0; s0 < M; s0 += 32 * kHeld) {
      T a[kHeld], sc[kHeld];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int s = s0 + 32 * k + lane;
        a[k] = s < M ? row[s] : T(0);
        sc[k] = s < M ? srow[s] : T(0);
        any = any || a[k] != T(0);
      }
      const bool test = interior && __any_sync(kFullMask, any);
      if (test && !listed) {
        // Frames f - 1 and f + 1, compacted: their nonzero values in
        // order, and whether a zero was among them.
        listed = true;
        __syncwarp();  // the previous frame's list is read
        for (int b0 = 0; b0 < 2 * M; b0 += 32 * kHeld) {
          T b[kHeld];
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            const int i = b0 + 32 * k + lane;
            b[k] = i < 2 * M ? (i < M ? row[i - M] : row[i]) : T(0);
          }
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            const bool in = b0 + 32 * k + lane < 2 * M;
            const unsigned nz = __ballot_sync(kFullMask, in && b[k] != T(0));
            zero_seen |= __ballot_sync(kFullMask, in && b[k] == T(0)) != 0u;
            if (in && b[k] != T(0)) list[n + __popc(nz & below)] = b[k];
            n += __popc(nz);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int s = s0 + 32 * k + lane;
        // Each nonzero slot of the chunk in turn, the lanes over the
        // list: the slot is kept once any |a - b| / a is not above the
        // limit (a NaN quotient is not), and zeroed when none is.
        bool kill = false;
        unsigned left =
            __ballot_sync(kFullMask, test && s < M && a[k] != T(0));
        while (left) {
          const int i = __ffs(left) - 1;
          left &= left - 1;
          const T ai = __shfl_sync(kFullMask, a[k], i);
          bool kept = false;
          for (int c = 0; c < n && !kept; c += 32) {
            const bool close =
                c + lane < n && !(magnitude(ai - list[c + lane]) / ai > limit);
            kept = __any_sync(kFullMask, close);
          }
          // Every zero neighbour gives |a - 0| / a = |a| / a.
          if (!kept && zero_seen) kept = !(magnitude(ai) / ai > limit);
          if (lane == i) kill = !kept;
        }
        if (s < M) {
          out_c[item * M + s] = kill ? T(0) : a[k];
          out_s[item * M + s] = kill ? T(0) : sc[k];
        }
      }
    }
  }
}

// Per device and type, once: the SM count and the most dynamic shared
// memory a block may opt in to (the kernel's limit raised to it).
template <typename T>
struct RemovePrepared {
  static std::atomic<int> sms[kMaxDevices];
  static std::atomic<int> smem_most[kMaxDevices];
};
template <typename T>
std::atomic<int> RemovePrepared<T>::sms[kMaxDevices];
template <typename T>
std::atomic<int> RemovePrepared<T>::smem_most[kMaxDevices];

template <typename T>
cudaError_t launch_remove(const void* cands, const void* scores, void* out_c,
                          void* out_s, int B, int F, int M,
                          cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = RemovePrepared<T>::sms[dev].load(std::memory_order_relaxed);
  int smem_most =
      RemovePrepared<T>::smem_most[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&smem_most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(remove_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_most);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    RemovePrepared<T>::smem_most[dev].store(smem_most,
                                            std::memory_order_relaxed);
    RemovePrepared<T>::sms[dev].store(sms, std::memory_order_relaxed);
  }
  // 8 warps a block, fewer where their lists (2 M values each) would
  // pass the shared memory a block may hold.
  const long long per_warp = 2LL * M * static_cast<long long>(sizeof(T));
  long long warps = smem_most / per_warp;
  if (warps < 1) return cudaErrorInvalidValue;
  if (warps > kWarps) warps = kWarps;
  const long long items = static_cast<long long>(B) * F;
  long long blocks = (items + warps - 1) / warps;
  const long long most = 8LL * sms;
  if (blocks > most) blocks = most;
  remove_kernel<T><<<static_cast<int>(blocks), static_cast<int>(32 * warps),
                     static_cast<size_t>(per_warp * warps), stream>>>(
      static_cast<const T*>(cands), static_cast<const T*>(scores),
      static_cast<T*>(out_c), static_cast<T*>(out_s), B, F, M);
  return cudaGetLastError();
}

}  // namespace

// y (B, Ly), positions (F,), cands (B, F, M), table float32 (ops/refine.py:
// kernel_table: the (2, 2^log2_max) phase table, then the window table's
// (hw_max (hw_max + 3) / 2, 2) entries), refined and scores (B, F, M)
// float32, all contiguous; 1 <= hw_max, log2_max = 2 + floor(log2(2 hw_max
// + 1)).
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
  // The staged table, then each warp's samples and slot list.
  const long long smem =
      8LL * (1LL << log2_max) + 4LL * kWarps * ((2LL * hw_max + 1) + kWindow);
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

// cands and scores (B, F, M), out_c and out_s (B, F, M) new tensors, all
// contiguous, of one type: float32 (elem_bytes 4) or float64 (8).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// another element size).
extern "C" int harvest_remove_unreliable(const void* cands,
                                         const void* scores, void* out_c,
                                         void* out_s, int B, int F, int M,
                                         int elem_bytes, void* stream) {
  if (B <= 0 || F <= 0 || M <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return static_cast<int>(
        launch_remove<float>(cands, scores, out_c, out_s, B, F, M, s));
  }
  if (elem_bytes == 8) {
    return static_cast<int>(
        launch_remove<double>(cands, scores, out_c, out_s, B, F, M, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
