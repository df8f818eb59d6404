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
// keeps the candidate, as torch's and JAX's minimum propagate it.  The
// test is "some |a - b| / a is not above 0.05", which does not depend on
// the order, so the outputs equal the plain version's.
// Design:
// - A block takes a tile of up to kTileMost consecutive frames of one row
//   (persistent blocks, as many as the card holds at once, walk the
//   tiles; a short call takes smaller tiles, so that it has a tile an
//   SM).  Frames f0 - 1 .. f0 + tile are one contiguous span: it is
//   copied into shared memory with every copy in flight (cp.async, 16
//   bytes each), with the tile's scores, so each frame is read once (and
//   two halo frames a tile), not once as itself and once as each
//   neighbour's neighbour.
// - A warp a frame compacts every staged frame once: its nonzero values
//   in slot order with their slots, and their count (a zero slot where it
//   is below M).  Each list then serves frames f - 1 and f + 1 both.
// - The division leaves the walk: per candidate a threshold t(a) with
//   !(|a - b| > t(a)) exactly when !(|a - b| / a > 0.05) (remove_threshold
//   says why), taken once a candidate.
// - A lane a candidate, a warp a frame: each lane walks the lists of f - 1
//   and f + 1 together (kWalk entries of each a step, 16-byte
//   shared-memory broadcasts into lists padded with +inf) to its first
//   close entry, with no shuffle and no vote; the candidates with none set
//   a kill bit.  The block then writes the tile's outputs in slot order,
//   16 bytes a thread, as it staged them.
// It reads its inputs and writes new outputs: every frame's test sees the
// values before any was zeroed.  Templated on float and double (the
// float64 exact path runs the same pass).  Other layouts timed: PERF.md
// §6.

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

// Per device and kernel, once: the SM count and the most dynamic shared
// memory a block may opt in to (the kernel's limit raised to it).  0
// until then.
template <auto kKernel>
struct Prepared {
  static std::atomic<int> sms[kMaxDevices];
  static std::atomic<int> smem_most[kMaxDevices];
};
template <auto kKernel>
std::atomic<int> Prepared<kKernel>::sms[kMaxDevices];
template <auto kKernel>
std::atomic<int> Prepared<kKernel>::smem_most[kMaxDevices];

template <auto kKernel>
cudaError_t prepare(int* sms, int* smem_most) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = Prepared<kKernel>::sms[dev].load(std::memory_order_relaxed);
  *smem_most =
      Prepared<kKernel>::smem_most[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(smem_most,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_most);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    Prepared<kKernel>::smem_most[dev].store(*smem_most,
                                            std::memory_order_relaxed);
    Prepared<kKernel>::sms[dev].store(*sms, std::memory_order_relaxed);
  }
  return err;
}

// ------------------------------------------- RemoveUnreliableCandidates

constexpr int kRemoveThreads = 256;
constexpr int kRemoveWarps = kRemoveThreads / 32;
constexpr int kTileMost = 32;               // frames a tile, at most
constexpr long long kTileBytes = 48 * 1024;  // a tile's shared memory, aim
constexpr int kWalk = 4;  // list entries a lane tests at once (load_walk)

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

// x moved by k units in the last place (x finite and >= 0, the result
// too).
__device__ __forceinline__ float ulp_step(float x, int k) {
  return __int_as_float(__float_as_int(x) + k);
}
__device__ __forceinline__ double ulp_step(double x, int k) {
  return __longlong_as_double(__double_as_longlong(x) + k);
}
__device__ __forceinline__ float infinity(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double infinity(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The threshold t(a): for every d, !(d > t(a)) == !(d / a > 0.05), with
// the quotient and 0.05 in T (ops/refine.py: remove_threshold is the same
// steps in torch).  For a finite a > 0 correctly rounded division is
// monotone in d, so the d with fl(d / a) <= 0.05 are those up to a
// largest t(a).  fl(0.05 a) is within half a unit in the last place of
// 0.05 a, and t(a) within 0.63 of a unit above it (the quotient's
// rounding boundary sits half a unit of 0.05 = 1.6 2^-5 above it), so
// t(a) is fl(0.05 a) or a unit to either side: one step, checked by the
// division, finds it (for every positive float32 on the card:
// tests/test_torch_cuda.py).  Otherwise (a < 0, +inf or NaN) no quotient
// is above 0.05 and t = +inf.
template <typename T>
__device__ __forceinline__ T remove_threshold(T a) {
  const T limit = static_cast<T>(0.05);
  const T inf = infinity(a);
  if (!(a > T(0) && a < inf)) return inf;
  const T t = limit * a;
  if (t / a > limit) return ulp_step(t, -1);
  const T up = ulp_step(t, 1);
  return up / a > limit ? t : up;
}

// kWalk list entries from 16-byte aligned shared memory.
__device__ __forceinline__ void load_walk(const float* p, float* b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void load_walk(const double* p, double* b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  const double2 w = *reinterpret_cast<const double2*>(p + 2);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = w.x;
  b[3] = w.y;
}

// Whether some entry b of frame f - 1's list p[0, np) or of frame f + 1's
// q[0, nq) is close to a: !(|a - b| > t), so a NaN a or b (and inf - inf)
// counts as close.  Both lists are walked together, kWalk entries of each
// a step in one or two 16-byte loads (a broadcast across the warp): each
// is 16-byte aligned and padded with +inf to a multiple of kWalk, so no
// entry is tested against its list's end (np and nq are the warp's).  A
// pad is close only where t = +inf, and then so is every entry.
template <typename T>
__device__ __forceinline__ bool any_close(const T* p, int np, const T* q,
                                          int nq, T a, T t) {
  const int n = np > nq ? np : nq;
  for (int j = 0; j < n; j += kWalk) {
    T b[2 * kWalk];
    if (j < np) {
      load_walk(p + j, b);
    } else {
#pragma unroll
      for (int k = 0; k < kWalk; ++k) b[k] = infinity(a);
    }
    if (j < nq) {
      load_walk(q + j, b + kWalk);
    } else {
#pragma unroll
      for (int k = kWalk; k < 2 * kWalk; ++k) b[k] = infinity(a);
    }
    bool close = false;
#pragma unroll
    for (int k = 0; k < 2 * kWalk; ++k) close |= !(magnitude(a - b[k]) > t);
    if (close) return true;
  }
  return false;
}

// Copies of 16 bytes, or of one element, from device to shared memory.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

// Elements of ``p`` past its last 16-byte boundary.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>(reinterpret_cast<size_t>(p) / sizeof(T) %
                          (16 / sizeof(T)));
}

// The ends of the 16-byte chunks of [0, n) past ``p`` (its elements
// [v0, v1)); none where ``wide`` is false.
template <typename T>
__device__ __forceinline__ void chunks(const T* p, int n, bool wide, int* v0,
                                       int* v1) {
  constexpr int kVec = 16 / sizeof(T);
  *v0 = wide ? min((kVec - misalign(p)) % kVec, n) : n;
  *v1 = *v0 + (n - *v0) / kVec * kVec;
}

// dst[0, n) = src[0, n), dst at src's offset from a 16-byte boundary:
// where ``wide``, 16-byte copies but at the ends; one element there.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n,
                                      bool wide) {
  constexpr int kVec = 16 / sizeof(T);
  int v0, v1;
  chunks(src, n, wide, &v0, &v1);
  for (int i = threadIdx.x; i < v0; i += kRemoveThreads) {
    copy_async(dst + i, src + i);
  }
  for (int i = v0 + kVec * threadIdx.x; i < v1; i += kVec * kRemoveThreads) {
    copy_async16(dst + i, src + i);
  }
  for (int i = v1 + threadIdx.x; i < n; i += kRemoveThreads) {
    copy_async(dst + i, src + i);
  }
}

// A block's shared memory for tiles of ``tile`` frames of M slots of
// ``elem`` bytes, G = tile + 2 frames with the two halo frames (byte
// offsets; every part aligned to its type; the two staged buffers start
// on 16-byte boundaries and hold 16 bytes more than their span, which
// starts at its own offset from a boundary).
struct RemoveLayout {
  long long raw;     // T[G M]: frames lo .. hi - 1 as read
  long long scores;  // T[tile M]: the tile's scores
  long long vals;    // T[G Mp]: each frame's nonzero values in slot order,
                     // padded with +inf to Mp = M rounded up to kWalk
  long long counts;  // int[G]: how many
  long long kills;   // unsigned[tile M / 32 + 2]: a bit an element zeroed
  long long slots;   // unsigned short[G M]: the slots of vals
  long long bytes;
};

__host__ __device__ inline RemoveLayout remove_layout(int tile, int M,
                                                     int elem) {
  const long long G = tile + 2;
  RemoveLayout l;
  l.raw = 0;
  l.scores = (l.raw + G * M * elem + 16 + 15) / 16 * 16;
  l.vals = (l.scores + static_cast<long long>(tile) * M * elem + 16 + 15) /
           16 * 16;
  l.counts = l.vals + G * ((M + kWalk - 1) / kWalk * kWalk) * elem;
  l.kills = l.counts + 4 * G;
  l.slots = l.kills + 4 * (static_cast<long long>(tile) * M / 32 + 2);
  l.bytes = (l.slots + 2 * G * M + 15) / 16 * 16;
  return l;
}

// Frames a tile: kTileMost, halved while the block passes kTileBytes
// (down to 1), then while the call has fewer tiles than ``sms`` (a short
// call wants blocks more than frames a block); 0 (the launch is refused)
// where three frames pass ``smem_most``.
int remove_tile(int B, int F, int M, int elem, int sms, int smem_most) {
  int tile = kTileMost;
  while (tile > 1 && remove_layout(tile, M, elem).bytes > kTileBytes) {
    tile /= 2;
  }
  if (remove_layout(tile, M, elem).bytes > smem_most) return 0;
  while (tile > 1 &&
         static_cast<long long>(B) * ((F + tile - 1) / tile) < sms) {
    tile /= 2;
  }
  return tile;
}

template <typename T>
__global__ void __launch_bounds__(kRemoveThreads)
    remove_kernel(const T* __restrict__ cands, const T* __restrict__ scores,
                  T* __restrict__ out_c, T* __restrict__ out_s, int B, int F,
                  int M, int tile, bool wide) {
  constexpr int kVec = 16 / sizeof(T);
  union Chunk {
    uint4 u;
    T x[kVec];
  };
  extern __shared__ __align__(16) unsigned char remove_smem[];
  const RemoveLayout lay = remove_layout(tile, M, sizeof(T));
  T* vals = reinterpret_cast<T*>(remove_smem + lay.vals);
  int* counts = reinterpret_cast<int*>(remove_smem + lay.counts);
  unsigned* kills = reinterpret_cast<unsigned*>(remove_smem + lay.kills);
  unsigned short* slots =
      reinterpret_cast<unsigned short*>(remove_smem + lay.slots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int Mp = (M + kWalk - 1) / kWalk * kWalk;  // a list's stride
  const int per_row = (F + tile - 1) / tile;
  const long long tiles = static_cast<long long>(B) * per_row;
  for (long long item = blockIdx.x; item < tiles; item += gridDim.x) {
    const int b = static_cast<int>(item / per_row);
    const int f0 = static_cast<int>(item - static_cast<long long>(b) *
                                               per_row) * tile;
    const int f1 = min(f0 + tile, F);  // the tile: frames f0 .. f1 - 1
    const int lo = max(f0 - 1, 0), hi = min(f1 + 1, F);  // staged
    const long long row = static_cast<long long>(b) * F;
    // Elements [e_lo, e_hi) of cands (frames lo .. hi - 1, one contiguous
    // span) and [o_lo, o_hi) of scores (the tile's), every copy in flight
    // at once; each buffer starts at its span's offset from a 16-byte
    // boundary, so that the 16-byte chunks of device memory land on
    // 16-byte chunks of shared memory.  The tile's kill bits cleared.
    const long long e_lo = (row + lo) * M, e_hi = (row + hi) * M;
    const long long o_lo = (row + f0) * M, o_hi = (row + f1) * M;
    T* raw = reinterpret_cast<T*>(remove_smem + lay.raw) +
             misalign(cands + e_lo);
    T* sc = reinterpret_cast<T*>(remove_smem + lay.scores) +
            misalign(scores + o_lo);
    stage(raw, cands + e_lo, static_cast<int>(e_hi - e_lo), wide);
    stage(sc, scores + o_lo, static_cast<int>(o_hi - o_lo), wide);
    const int n_out = static_cast<int>(o_hi - o_lo);
    for (int i = threadIdx.x; i < n_out / 32 + 2; i += kRemoveThreads) {
      kills[i] = 0u;
    }
    asm volatile("cp.async.commit_group;\n"
                 "cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // Each staged frame compacted once, a warp a frame: its nonzero
    // values (NaN too) and their slots in slot order, and their count
    // (a frame has a zero slot where it is below M); the list padded.
    for (int g = warp; g < hi - lo; g += kRemoveWarps) {
      const T* fr = raw + static_cast<long long>(g) * M;
      T* v = vals + static_cast<long long>(g) * Mp;
      unsigned short* sl = slots + static_cast<long long>(g) * M;
      int n = 0;
      for (int base = 0; base < M; base += 32) {
        const int s = base + lane;
        const T x = s < M ? fr[s] : T(0);
        const bool nz = x != T(0);
        const unsigned ballot = __ballot_sync(kFullMask, nz);
        if (nz) {
          const int at = n + __popc(ballot & below);
          v[at] = x;
          sl[at] = static_cast<unsigned short>(s);
        }
        n += __popc(ballot);
      }
      if (n + lane < (n + kWalk - 1) / kWalk * kWalk) {
        v[n + lane] = infinity(T(0));
      }
      if (lane == 0) counts[g] = n;
    }
    __syncthreads();
    // The tile's interior frames, a warp a frame, a lane a candidate:
    // each walks the lists of frames f - 1 and f + 1 to its first close
    // entry; a zero neighbour gives |a - 0| = |a|.  A candidate with none
    // sets its element's kill bit.
    for (int f = f0 + warp; f < f1; f += kRemoveWarps) {
      if (f == 0 || f == F - 1) continue;
      const int g = f - lo;
      const long long at = static_cast<long long>(g) * Mp;
      const int n = counts[g], n_prev = counts[g - 1], n_next = counts[g + 1];
      const bool zero_near = n_prev < M || n_next < M;
      for (int i = lane; i < n; i += 32) {
        const T a = vals[at + i];
        const T t = remove_threshold(a);
        const bool kept =
            any_close(vals + at - Mp, n_prev, vals + at + Mp, n_next, a, t) ||
            (zero_near && !(magnitude(a) > t));
        if (!kept) {
          const int e = (f - f0) * M + slots[g * M + i];
          atomicOr(kills + (e >> 5), 1u << (e & 31));
        }
      }
    }
    __syncthreads();
    // The tile's outputs, elements [o_lo, o_hi): 16 bytes a thread where
    // ``wide`` (every pointer 16-byte aligned, so the chunks of the four
    // tensors and of the two buffers line up), one element at the ends.
    const T* src = raw + (o_lo - e_lo);
    T* oc = out_c + o_lo;
    T* os = out_s + o_lo;
    int v0, v1;
    chunks(oc, n_out, wide, &v0, &v1);
    for (int i = v0 + kVec * threadIdx.x; i < v1; i += kVec * kRemoveThreads) {
      const unsigned bits =
          __funnelshift_r(kills[i >> 5], kills[(i >> 5) + 1], i & 31);
      Chunk c, s;
      c.u = *reinterpret_cast<const uint4*>(src + i);
      s.u = *reinterpret_cast<const uint4*>(sc + i);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const bool kill = (bits >> k) & 1u;
        c.x[k] = kill ? T(0) : c.x[k];
        s.x[k] = kill ? T(0) : s.x[k];
      }
      *reinterpret_cast<uint4*>(oc + i) = c.u;
      *reinterpret_cast<uint4*>(os + i) = s.u;
    }
    for (int i = threadIdx.x; i < n_out; i += kRemoveThreads) {
      const int at = i < v0 ? i : v1 + (i - v0);  // the ends
      if (at >= n_out) break;
      const bool kill = (kills[at >> 5] >> (at & 31)) & 1u;
      oc[at] = kill ? T(0) : src[at];
      os[at] = kill ? T(0) : sc[at];
    }
    __syncthreads();  // the shared memory is free for the next tile
  }
}

template <typename T>
cudaError_t launch_remove(const void* cands, const void* scores, void* out_c,
                          void* out_s, int B, int F, int M,
                          cudaStream_t stream) {
  if (M > 65535) return cudaErrorInvalidValue;  // slots are 16-bit
  int sms = 0, smem_most = 0;
  cudaError_t err = prepare<&remove_kernel<T>>(&sms, &smem_most);
  if (err != cudaSuccess) return err;
  const int tile = remove_tile(B, F, M, sizeof(T), sms, smem_most);
  if (tile < 1) return cudaErrorInvalidValue;
  // 16-byte copies where every tensor starts on a 16-byte boundary.
  const bool wide =
      (reinterpret_cast<size_t>(cands) | reinterpret_cast<size_t>(scores) |
       reinterpret_cast<size_t>(out_c) | reinterpret_cast<size_t>(out_s)) %
          16 == 0;
  const long long smem = remove_layout(tile, M, sizeof(T)).bytes;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, remove_kernel<T>, kRemoveThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) * ((F + tile - 1) / tile);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  remove_kernel<T><<<static_cast<int>(blocks), kRemoveThreads,
                     static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(cands), static_cast<const T*>(scores),
      static_cast<T*>(out_c), static_cast<T*>(out_s), B, F, M, tile, wide);
  return cudaGetLastError();
}

template <typename T>
__global__ void threshold_kernel(const T* __restrict__ a, T* __restrict__ t,
                                 long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    t[i] = remove_threshold(a[i]);
  }
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
  int sms = 0, smem_most = 0;
  cudaError_t err = prepare<&refine_kernel>(&sms, &smem_most);
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
// another element size, or where three frames pass the shared memory a
// block may hold).
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

// t (n,) = remove_threshold(a (n,)), the reliability pass's threshold
// (float32, elem_bytes 4, or float64, 8), for the tests.  Returns the
// cudaError_t of the launch.
extern "C" int harvest_remove_threshold(const void* a, void* t, int n,
                                        int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  if (elem_bytes == 4) {
    threshold_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<float*>(t), n);
  } else if (elem_bytes == 8) {
    threshold_kernel<double><<<blocks, 256, 0, s>>>(
        static_cast<const double*>(a), static_cast<double*>(t), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
