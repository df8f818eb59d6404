// Harvest's FixStep3 (Extend + Merge, src/harvest.cpp:791-995), CUDA C++
// for sm_90a.
//
// Replaces the JAX package's device loops over sections
// (world_tpu/models/harvest_contour.py:114-139 and 158-306: lax.scan for
// ExtendF0 and ExtendSub, lax.while_loop for the extension chunks, the
// frame scores and MergeF0), which the port's plain version runs as
// Python loops (world_tpu_torch/models/harvest_contour.py: _fix_step3,
// _extend; thousands of launches a call).  Per row, in order:
//   1. the voiced sections of step2 (runs inside frames 1..F-2), the first
//      kmax of them (kmax: the wrapper's capacity or cap);
//   2. ExtendF0 from each end of each section, up to 101 steps toward
//      min(ed + 100, F - 2) or max(st - 100, 1): each step takes the
//      candidate of frame t nearest the last hit (SelectBestF0: error
//      |ref - c| / ref, the LAST of equal minima, a NaN error counting as
//      the minimum, kept when error <= allowed_range) and the walk stops
//      after 4 straight misses; the section's new end is its last hit;
//   3. ExtendSub: mean = (mean + sum of the section's values over
//      [new_st, new_ed)) / (new_ed - new_st), carried from section to
//      section; a section is kept when 2200 / mean < its length, where
//      2200 / mean is, as in PyTorch, mean's reciprocal times 2200;
//   4. the kept sections in their order, then ordered by new start
//      (a stable sort);
//   5. each kept section's frame scores: at frame t, the best score among
//      t's slots whose candidate equals the section's value there (0 if
//      none; a NaN score wins, as torch.amax has it);
//   6. MergeF0: the first kept section, then each next one in start order
//      written over [new_st, new_ed] when it starts past the merged end,
//      over [lo, new_ed] when it overlaps (lo the merged end if the merged
//      scores over [new_st, merged end] sum higher than the section's,
//      else new_st), not at all when contained;
//   7. the merged row, or step2 where no section was kept.
// Divisions are IEEE and nothing is contracted (the source is built with
// -fmad=false, and the operations that carry rounding are the _rn
// intrinsics), so every value is the plain version's, with one exception:
// the sums of 3. and 6. are taken in frame order in the row's type, the
// reference's order (the loops of ExtendSub and MergeF0Sub in
// src/harvest.cpp), where the plain version uses torch.sum.  The two
// differ only where such a sum decides its comparison to within its
// rounding.
//
// Bound: the chain.  Each step of a walk waits for the last hit (one
// divide deep), ExtendSub's mean is one divide per section, and MergeF0
// goes section after section; bytes (step2, cands, scores and the output,
// once each) are far below it.  So a walk step should cost little more
// than one divide and a few warp reductions.
//
// Design.  A row is a cluster of up to kCluster blocks of kWarps warps
// (the most at which the card holds every row's cluster at once), in
// three phases split by cluster barriers, the walks' results passed
// through the row's scratch:
//   A. the leader block finds the sections: each warp ballots over its
//      chunk of frames, twice (count, then place after the warps' prefix);
//   B. the cluster's warps take the 2K walks (consecutive walks on other
//      blocks and other warp schedulers), one warp a walk and its lanes
//      over the candidate slots.  A walk step only selects: the least
//      |ref - c| by one warp reduction, one divide, and the last slot at
//      that least by another (select: every slot's quotient only where
//      rounding could tie two of them); masks and selects, not branches,
//      so the warp meets no convergence barrier inside a step.  Each lane
//      keeps the next kDepth frames' slots in registers (S <= 128: a
//      compile-time count of slots a lane, the loop unrolled; a general
//      loop for larger S), so the loads of later steps are in flight while
//      a step reduces.  The frame scores of a walk's steps are taken after
//      it, kGroup steps side by side; every warp takes groups of kGroup
//      frames' scores of step2's value and of 0 from a counter when it is
//      free (the warps with no walk from the start);
//   C. the leader block: each section's span sum (a warp per section, in
//      frame order by shuffles), the carried mean and the kept list (one
//      thread), the start order (a rank per kept section), the first kept
//      section written by the block, then MergeF0 by one warp: the
//      sections' bounds fetched 32 at a time and broadcast by shuffles,
//      the overlap sums in frame order by shuffles, each write closed by
//      __syncwarp().
// Loads that feed one step are all issued before any is used (addresses
// clamped into the row, values masked).  A section's values are kept
// compactly: its step2 interior is read from step2, the two walks' values
// and frame scores go in 101-entry lists in the row's scratch.  The merged
// row and its scores live in shared memory where 2F values fit under
// kSmemMax, else in the scratch.  The section count K is found in the
// kernel (no host sync); the scratch holds kmax sections.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                 // blocks a row, at most
constexpr int kSteps = 101;                 // walk steps, 100-frame threshold
constexpr int kHeader = 3;                  // count, K, frame groups
constexpr int kLists = 7;                   // int lists per row, kmax each
constexpr int kGroup = 8;                   // steps, frames scored side by side
constexpr int kSmemMax = 160 * 1024;        // merged row + scores in smem
constexpr int kSmemDefault = 48 * 1024;     // no opt-in needed below this
constexpr unsigned kFull = 0xffffffffu;

// Frames whose slots a lane holds ahead of the walk.
template <typename T>
constexpr int kDepth = sizeof(T) == 4 ? 8 : 4;

template <typename T> struct Rn;
template <> struct Rn<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float rcp(float a) { return __frcp_rn(a); }
};
template <> struct Rn<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double rcp(double a) { return __drcp_rn(a); }
};

// Order-keeping unsigned keys of a type's values (ord: x < y exactly when
// ord(x) < ord(y), for every non-NaN x, y; -0 below +0) and warp-wide
// minima and maxima of such keys by redux (two rounds for 64 bits).
template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned;
  static constexpr U kTop = 0xffffffffu;
  static constexpr float kMin = 1.17549435e-38f;      // least normal
  static constexpr float kMax = 3.40282347e+38f;
  static constexpr float kNear = 1.0f + 0x1p-20f;     // see select
  __device__ static U ord(float x) {
    const U u = __float_as_uint(x);
    return (u >> 31) ? ~u : (u | 0x80000000u);
  }
  __device__ static float unord(U k) {
    return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
  }
  __device__ static U warp_min(U k) { return __reduce_min_sync(kFull, k); }
  __device__ static U warp_max(U k) { return __reduce_max_sync(kFull, k); }
};
template <> struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kTop = ~0ull;
  static constexpr double kMin = 2.2250738585072014e-308;
  static constexpr double kMax = 1.7976931348623157e+308;
  static constexpr double kNear = 1.0 + 0x1p-45;
  __device__ static U ord(double x) {
    const U u = static_cast<U>(__double_as_longlong(x));
    return (u >> 63) ? ~u : (u | (1ull << 63));
  }
  __device__ static double unord(U k) {
    return __longlong_as_double(static_cast<long long>(
        (k >> 63) ? (k & ~(1ull << 63)) : ~k));
  }
  __device__ static U warp_min(U k) {
    const unsigned hi = __reduce_min_sync(kFull, unsigned(k >> 32));
    const unsigned lo = __reduce_min_sync(
        kFull, unsigned(k >> 32) == hi ? unsigned(k) : 0xffffffffu);
    return (U(hi) << 32) | lo;
  }
  __device__ static U warp_max(U k) {
    const unsigned hi = __reduce_max_sync(kFull, unsigned(k >> 32));
    const unsigned lo = __reduce_max_sync(
        kFull, unsigned(k >> 32) == hi ? unsigned(k) : 0u);
    return (U(hi) << 32) | lo;
  }
};

// SelectBestF0's order of an error: 0 for NaN (a NaN error is the
// minimum), then the errors in order; -0 counts as +0.
template <typename T>
__device__ typename Bits<T>::U error_key(T e) {
  return isnan(e) ? 0 : Bits<T>::ord(e == T(0) ? T(0) : e) + 1;
}

// torch.amax over the warp's lanes: a NaN wins (returned as a quiet NaN:
// a score only ever enters sums and comparisons).
template <typename T>
__device__ T warp_max(T m) {
  using B = Bits<T>;
  const typename B::U k = B::warp_max(isnan(m) ? B::kTop : B::ord(m));
  return k == B::kTop ? static_cast<T>(NAN) : B::unord(k);
}

// The warp's SelectBestF0 from each lane's best slot j (key k: error_key,
// kTop for a lane with no slot; candidate cv): the least key, then the
// later slot.  Returns the winner's candidate if its error is within
// allowed, else 0.
template <typename T>
__device__ T pick(typename Bits<T>::U k, int j, T cv, T allowed) {
  using B = Bits<T>;
  const typename B::U best = B::warp_min(k);
  const unsigned tie = __reduce_min_sync(
      kFull, k == best && j >= 0 ? ~unsigned(j) : 0xffffffffu);
  const int w = static_cast<int>(~tie);
  cv = __shfl_sync(kFull, cv, w & 31);
  const T e = best == 0 ? static_cast<T>(NAN) : B::unord(best - 1);
  return (w >= 0 && e <= allowed) ? cv : T(0);
}

// Lane-local SelectBestF0 step: slot j with error e and candidate c
// against the lane's best so far.
template <typename T>
__device__ __forceinline__ void keep_best(typename Bits<T>::U& bk, int& bj,
                                          T& bcv, T e, int j, T c) {
  const typename Bits<T>::U k = error_key(e);
  if (k < bk || (k == bk && j > bj)) {
    bk = k;
    bj = j;
    bcv = c;
  }
}

// One lane's slots j = lane + 32 n (n < NS) of frame t's candidates, or
// zeros where the walk takes no step s (ok false) or j >= S.
template <typename T, int NS>
__device__ __forceinline__ void fetch(T (&dst)[NS], const T* cr, int S,
                                      int t, bool ok, int lane) {
  const T* c = cr + static_cast<size_t>(ok ? t : 0) * S;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int j = lane + 32 * n;
    const T x = c[min(j, S - 1)];       // every load issued, none waited on
    dst[n] = (ok && j < S) ? x : T(0);
  }
}

// c[n], or 0 past the lane's NS slots.
template <int n, typename T, int NS>
__device__ __forceinline__ T slot_at(const T (&c)[NS]) {
  if constexpr (n < NS) {
    return c[n];
  } else {
    return T(0);
  }
}

// SelectBestF0 from every slot's quotient: a lane's slots c0..c3 (zeros
// past S).  Out of line: select needs it only in rare frames, and the
// walk's unrolled steps stay small.
template <typename T>
__device__ __noinline__ T select_every(T ref, T allowed, int S, int lane,
                                       T c0, T c1, T c2, T c3) {
  const T c[4] = {c0, c1, c2, c3};
  typename Bits<T>::U bk = Bits<T>::kTop;
  int bj = -1;
  T bcv = T(0);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = lane + 32 * n;
    if (j < S) {
      keep_best(bk, bj, bcv, Rn<T>::div(fabs(Rn<T>::sub(ref, c[n])), ref),
                j, c[n]);
    }
  }
  return pick(bk, bj, bcv, allowed);
}

// SelectBestF0 of a frame whose slots the lanes hold in c: each slot's
// error is |ref - c| / ref, rounded.  For ref > 0 (finite) a rounded
// quotient never falls as its dividend grows, so where no dividend is
// NaN the least error is amin / ref (amin the least |ref - c|), and the
// slots that reach it are those with |ref - c| == amin, plus any whose
// dividend lies so close above amin (within kNear: 2^-20 relative in
// float32, 2^-45 in float64, where a normal quotient rounds by at most
// 2^-24 or 2^-53) that its quotient may round to the same value.  So a
// step takes one divide, unless such a near slot, a NaN, a subnormal or
// infinite amin or quotient, or a ref outside (0, max] asks for every
// slot's quotient, which gives the same value.  A NaN dividend (with such
// a ref, a NaN error) wins the argmin, and a NaN error is never within
// allowed: the step selects 0.
template <typename T, int NS>
__device__ __forceinline__ T select(const T (&c)[NS],
                                    const typename Bits<T>::U (&pad)[NS],
                                    T ref, T allowed, int S, int lane) {
  using B = Bits<T>;
  using U = typename B::U;
  // Masks and selects, not branches, over the slots (pad: 0 for a slot
  // the lane holds, all ones past S): a step is short, and a branch
  // region costs the warp a convergence barrier.
  T a[NS];
  U key = B::kTop;                      // least |ref - c|, 0 for a NaN
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = fabs(Rn<T>::sub(ref, c[n]));
    key = min(key, error_key(a[n]) | pad[n]);
  }
  if (ref > T(0) && ref <= B::kMax) {
    const U least = B::warp_min(key);
    if (least == 0) return T(0);
    const T amin = B::unord(least - 1);
    const T e = Rn<T>::div(amin, ref);
    if (amin >= B::kMin && e >= B::kMin && e <= B::kMax) {
      const T lim = Rn<T>::mul(amin, B::kNear);
      bool near = false;
      int last = -1;
      T mine = T(0);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bool in = pad[n] == 0, at = in && a[n] == amin;
        last = at ? lane + 32 * n : last;
        mine = at ? c[n] : mine;
        near = near || (in && !at && a[n] <= lim);
      }
      // The last slot at amin, or all ones where a slot is near.
      const unsigned r = __reduce_max_sync(
          kFull, near ? 0xffffffffu : unsigned(last + 1));
      if (r != 0xffffffffu) {
        const T cv = __shfl_sync(kFull, mine, (r - 1) & 31);
        return e <= allowed ? cv : T(0);
      }
    }
  }
  return select_every<T>(ref, allowed, S, lane, slot_at<0>(c),
                         slot_at<1>(c), slot_at<2>(c), slot_at<3>(c));
}

// torch.amax's step: a NaN wins, and m stays where x does not exceed it.
template <typename T>
__device__ __forceinline__ void take_max(T& m, T x) {
  m = (isnan(m) || x <= m) ? m : x;     // a NaN x: not <=, so taken
}

// The lane's part of the best score among a frame's slots whose candidate
// equals v (0 for the others), into mv, and with kZero of those whose
// candidate is 0, into mz: NS slots a lane (their loads issued first), or
// every 32nd (NS 0).  -0 and +0 may come out either way, as only sums of
// scores are compared.
template <typename T, int NS, bool kZero>
__device__ __forceinline__ void slot_scores(const T* c, const T* s, int S,
                                            T v, int lane, T& mv, T& mz) {
  mv = mz = -static_cast<T>(INFINITY);
  if constexpr (NS > 0) {
    T cc[NS], ss[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int j = min(lane + 32 * n, S - 1);
      cc[n] = c[j];
      ss[n] = s[j];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const bool in = lane + 32 * n < S;
      const T none = -static_cast<T>(INFINITY);
      const T xv = cc[n] == v ? ss[n] : T(0);
      const T xz = cc[n] == T(0) ? ss[n] : T(0);
      take_max(mv, in ? xv : none);
      if (kZero) take_max(mz, in ? xz : none);
    }
  } else {
    for (int j = lane; j < S; j += 32) {
      const T cj = c[j], sj = s[j];
      take_max(mv, cj == v ? sj : T(0));
      if (kZero) take_max(mz, cj == T(0) ? sj : T(0));
    }
  }
}

// ExtendF0 by one warp: walk n_steps frames from origin in direction dir
// starting from ref, the value of each step into vals.  Returns the last
// hit's frame (origin when none).
template <typename T, int NS>
__device__ int walk(const T* cr, int S, int F, int origin, int dir,
                    int n_steps, T ref, T allowed, T* vals, int lane) {
  int misses = 0, shifted = origin, s = 0;
  if constexpr (NS > 0) {
    constexpr int D = kDepth<T>;
    typename Bits<T>::U pad[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pad[n] = lane + 32 * n < S ? 0 : Bits<T>::kTop;
    }
    T buf[D][NS];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = origin + dir * (d + 1);
      fetch(buf[d], cr, S, t, d < n_steps && t >= 0 && t < F, lane);
    }
    bool go = n_steps > 0;
    while (go) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (go) {
          const T v = select(buf[d], pad, ref, allowed, S, lane);
          const int ahead = s + D, ta = origin + dir * (ahead + 1);
          fetch(buf[d], cr, S, ta, ahead < n_steps && ta >= 0 && ta < F,
                lane);
          vals[s] = v;                  // every lane: one store
          const bool hit = v != T(0);
          ref = hit ? v : ref;
          shifted = hit ? origin + dir * (s + 1) : shifted;
          misses = hit ? 0 : misses + 1;
          ++s;
          go = s < n_steps && misses < 4;
        }
      }
    }
  } else {
    for (; s < n_steps && misses < 4; ++s) {
      const int t = origin + dir * (s + 1);
      const bool inside = t >= 0 && t < F;
      const T* c = cr + static_cast<size_t>(inside ? t : 0) * S;
      typename Bits<T>::U bk = Bits<T>::kTop;
      int bj = -1;
      T bcv = T(0);
      for (int j = lane; j < S; j += 32) {
        const T cj = inside ? c[j] : T(0);
        keep_best(bk, bj, bcv, Rn<T>::div(fabs(Rn<T>::sub(ref, cj)), ref),
                  j, cj);
      }
      const T v = pick(bk, bj, bcv, allowed);
      if (lane == 0) vals[s] = v;
      if (v != T(0)) {
        ref = v;
        shifted = t;
        misses = 0;
      } else {
        ++misses;
      }
    }
  }
  return shifted;
}

// One section: the plain version's multi[k, t] and frame_score[k, t]
// read back from the compact lists, one load a frame (a pointer that is
// always inside the row's scratch, its value masked where unused).
template <typename T>
struct Section {
  int a, b, lo, hi;                   // new start and end; step2's
  const T *s2, *right, *left;         // values: t - hi - 1, lo - t - 1
  const T *in_score, *zero_score, *rscore, *lscore;

  __device__ T value(int t) const {
    const T* p = t > hi ? right + (t - hi - 1)
                        : t < lo ? left + (lo - t - 1) : s2 + t;
    const T x = *p;
    if (t < a || t > b) return T(0);
    return (t > hi || t < lo) ? T(0) + x : x;
  }
  __device__ T frame(int t) const {
    const T* p = (t < a || t > b) ? zero_score + t
                 : t > hi ? rscore + (t - hi - 1)
                 : t < lo ? lscore + (lo - t - 1) : in_score + t;
    return *p;
  }
};

// A row's sections: bounds lists and the walks' lists, [2k + (left)].
template <typename T>
struct Sections {
  const T* s2;
  const int *st, *ed, *nst, *ned;   // step2's bounds; extended bounds
  const T *val, *score;             // [2k + (left)][step]
  const T *in_score, *zero_score;   // frame scores of step2's value, of 0

  __device__ Section<T> at(int k, int a, int b, int lo, int hi) const {
    const size_t r = 2 * k * static_cast<size_t>(kSteps);
    return {a, b, lo, hi, s2, val + r, val + r + kSteps, in_score,
            zero_score, score + r, score + r + kSteps};
  }
  __device__ Section<T> operator[](int k) const {
    return at(k, nst[k], ned[k], st[k], ed[k]);
  }
};

// GetBoundaryList's voicing: frames 0 and F-1 count as unvoiced.
template <typename T>
__device__ bool voiced_at(const T* s2, int j, int F) {
  return j > 0 && j < F - 1 && s2[j] != T(0);
}

// sum_{t in [lo, hi)} x(t) in frame order, every lane the same sum: the
// lanes load 128 frames at a time (x at a frame past hi is read but not
// added) and shuffle them to each other.
template <typename T, typename X>
__device__ T warp_sum_in_order(T acc, int lo, int hi, int lane, X x) {
  for (int base = lo; base < hi; base += 4 * 32) {
    T mine[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) mine[u] = x(min(base + 32 * u + lane, hi - 1));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = hi - base - 32 * u;
#pragma unroll
      for (int l = 0; l < 32; ++l) {    // the shuffles issued together
        const T y = __shfl_sync(kFull, mine[u], l);
        if (l < n) acc = Rn<T>::add(acc, y);
      }
    }
  }
  return acc;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 1)
harvest_fix_step3_kernel(const T* __restrict__ step2,
                         const T* __restrict__ cands,
                         const T* __restrict__ scores, T* out,
                         int* iscratch, T* fscratch, int F, int S, int kmax,
                         T allowed, bool merge_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sh_warp_st[kWarps], sh_warp_ed[kWarps], sh_kept;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x / csize;
  const T* s2 = step2 + row * F;
  const T* cr = cands + row * F * static_cast<size_t>(S);
  const T* sr = scores + row * F * static_cast<size_t>(S);
  T* o = out + row * F;
  int* head = iscratch + row * (kHeader + kLists * static_cast<size_t>(kmax));
  int* st = head + kHeader;
  int* ed = st + kmax;
  int* nst = ed + kmax;
  int* ned = nst + kmax;
  int* kept = ned + kmax;
  int* keys = kept + kmax;          // new start of each kept section
  int* sorted = keys + kmax;        // kept sections by new start
  // The row's float scratch (ops/contour.py: harvest_scratch).
  T* val = fscratch + row * ((4 * kSteps + 1) * static_cast<size_t>(kmax)
                             + 4 * static_cast<size_t>(F));
  T* score = val + 2 * kSteps * kmax;
  T* sums = score + 2 * kSteps * kmax;
  T* in_score = sums + kmax;
  T* zero_score = in_score + F;
  T* merged = merge_in_smem ? reinterpret_cast<T*>(smem_raw)
                            : zero_score + F;
  T* mscore = merged + F;
  const Sections<T> sec{s2, st, ed, nst, ned, val, score, in_score,
                        zero_score};

  // A. Section bounds, the leader block: each warp ballots over its chunk
  // of frames, counting, then placing after the warps before it.
  if (rank == 0) {
    const int chunk = (F + kThreads - 1) / kThreads * 32;
    const int lo = warp * chunk, hi = min(lo + chunk, F);
    const unsigned below = (1u << lane) - 1u;
    int n_st = 0, n_ed = 0;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        if (lane == 0) {
          sh_warp_st[warp] = n_st;
          sh_warp_ed[warp] = n_ed;
        }
        __syncthreads();
        n_st = n_ed = 0;
        for (int w = 0; w < warp; ++w) {
          n_st += sh_warp_st[w];
          n_ed += sh_warp_ed[w];
        }
      }
#pragma unroll 4
      for (int base = lo; base < hi; base += 32) {
        const int j = base + lane;
        const bool v = j < hi && voiced_at(s2, j, F);
        const bool is_st = v && !voiced_at(s2, j - 1, F);
        const bool is_ed = v && !voiced_at(s2, j + 1, F);
        const unsigned ms = __ballot_sync(kFull, is_st);
        const unsigned me = __ballot_sync(kFull, is_ed);
        if (pass == 1) {
          const int ps = n_st + __popc(ms & below);
          const int pe = n_ed + __popc(me & below);
          if (is_st && ps < kmax) st[ps] = j;
          if (is_ed && pe < kmax) ed[pe] = j;
        }
        n_st += __popc(ms);
        n_ed += __popc(me);
      }
    }
    if (tid == kThreads - 1) {      // the last warp's count is the row's
      head[0] = n_st;
      head[1] = min(n_st, kmax);
      head[2] = 0;                  // frame groups taken (B.)
    }
  }
  __threadfence();
  cluster.sync();
  const int count = head[0], K = head[1];

  // B. ExtendF0, walk q being section q / 2, rightward for even q, and
  // its steps' frame scores (5.); then the frame scores of step2's value
  // and of 0 at every frame, kGroup frames at a time, each warp taking
  // the next group when it is free.  Consecutive walks go to different
  // blocks, then to different warp schedulers of a block (warp % 4).
  const int gw = warp * csize + rank, n_gw = csize * kWarps;
  for (int q = gw; q < 2 * K; q += n_gw) {
    const int k = q >> 1;
    const int dir = (q & 1) ? -1 : 1;
    const int origin = dir > 0 ? ed[k] : st[k];
    const int last = dir > 0 ? min(origin + 100, F - 2)
                             : max(origin - 100, 1);
    const int n_steps = min(abs(last - origin) + 1, kSteps);
    T* vals = val + q * kSteps;
    T* fss = score + q * kSteps;
    const int shifted = walk<T, NS>(cr, S, F, origin, dir, n_steps,
                                    s2[origin], allowed, vals, lane);
    if (lane == 0) (dir > 0 ? ned : nst)[k] = shifted;
    __syncwarp();
    // Only the steps up to the last hit are read back (Sections).
    const int n_hit = (shifted - origin) * dir;
    for (int s0 = 0; s0 < n_hit; s0 += kGroup) {
      T m[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int s = min(s0 + g, n_hit - 1);     // loads issued together
        const size_t t = origin + dir * (s + 1);
        T unused;
        slot_scores<T, NS, false>(cr + t * S, sr + t * S, S, vals[s], lane,
                                  m[g], unused);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) m[g] = warp_max(m[g]);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (s0 + g < n_hit) fss[s0 + g] = m[g];
        }
      }
    }
  }
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(head + 2, 1);
    const int t0 = __shfl_sync(kFull, g, 0) * kGroup;
    if (t0 >= F) break;
    T mv[kGroup], mz[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = min(t0 + u, F - 1);
      slot_scores<T, NS, true>(cr + static_cast<size_t>(t) * S,
                               sr + static_cast<size_t>(t) * S, S, s2[t],
                               lane, mv[u], mz[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      mv[u] = warp_max(mv[u]);
      mz[u] = warp_max(mz[u]);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (t0 + u < F) {
          in_score[t0 + u] = mv[u];
          zero_score[t0 + u] = mz[u];
        }
      }
    }
  }
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  // C. The leader block.  3. ExtendSub: each section's sum over
  // [new_st, new_ed) in frame order, a warp each; then the mean carried
  // over the sections in order, and the kept list.
  for (int k = warp; k < K; k += kWarps) {
    const Section<T> z = sec[k];
    const T acc = warp_sum_in_order(T(0), z.a, z.b, lane,
                                    [&](int t) { return z.value(t); });
    if (lane == 0) sums[k] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    constexpr int kBatch = 8;           // loads ahead of the divide chain
    T mean = T(0);
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      T sk[kBatch];
      int a[kBatch], b[kBatch];
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
        const int k = min(k0 + g, K - 1);
        sk[g] = sums[k];
        a[g] = nst[k];
        b[g] = ned[k];
      }
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
        if (k0 + g < K) {
          const T len = static_cast<T>(b[g] - a[g]);
          mean = Rn<T>::div(Rn<T>::add(mean, sk[g]), len);
          kept[n] = k0 + g;             // kept when n moves on
          keys[n] = a[g];
          n += Rn<T>::mul(Rn<T>::rcp(mean), T(2200)) < len;
        }
      }
    }
    sh_kept = n;
  }
  __syncthreads();
  const int n_kept = sh_kept;

  // 4. The kept sections by new start, ties in kept order.
  for (int i = tid; i < n_kept; i += kThreads) {
    const int key = keys[i];
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < n_kept; ++j) {
      const int kj = keys[j];
      r += kj < key || (kj == key && j < i);
    }
    sorted[r] = kept[i];
  }

  // 6. MergeF0 from the first kept section (in kept order), then one warp
  // over the others in start order.
  if (n_kept > 0) {
    const Section<T> z = sec[kept[0]];
    for (int t = tid; t < F; t += kThreads) {
      merged[t] = z.value(t);
      mscore[t] = z.frame(t);
    }
  }
  __syncthreads();
  if (warp == 0 && n_kept > 1) {
    int b0 = nst[kept[0]], b1 = ned[kept[0]];
    for (int i0 = 1; i0 < n_kept; i0 += 32) {
      // Each lane fetches one section's bounds; the loop broadcasts them.
      const int mine = i0 + lane;
      int km = 0, am = 0, bm = 0, lm = 0, hm = 0;
      if (mine < n_kept) {
        km = sorted[mine];
        am = nst[km];
        bm = ned[km];
        lm = st[km];
        hm = ed[km];
      }
      const int n = min(32, n_kept - i0);
      for (int l = 0; l < n; ++l) {
        const Section<T> z = sec.at(
            __shfl_sync(kFull, km, l), __shfl_sync(kFull, am, l),
            __shfl_sync(kFull, bm, l), __shfl_sync(kFull, lm, l),
            __shfl_sync(kFull, hm, l));
        const int st2 = z.a, ed2 = z.b;
        const bool disjoint = st2 - b1 > 0;
        const bool contained = b0 <= st2 && b1 >= ed2;
        int from = st2;
        if (!disjoint && !contained) {
          const T score1 = warp_sum_in_order(
              T(0), st2, b1 + 1, lane, [&](int t) { return mscore[t]; });
          const T score2 = warp_sum_in_order(
              T(0), st2, b1 + 1, lane, [&](int t) { return z.frame(t); });
          from = score1 > score2 ? b1 : st2;
        }
        if (!contained) {
          constexpr int kWide = 8;      // frames a lane loads at once
          for (int t0 = from; t0 <= ed2; t0 += kWide * 32) {
            T mv[kWide], ms[kWide];
#pragma unroll
            for (int u = 0; u < kWide; ++u) {
              const int t = min(t0 + 32 * u + lane, ed2);
              mv[u] = z.value(t);
              ms[u] = z.frame(t);
            }
#pragma unroll
            for (int u = 0; u < kWide; ++u) {
              const int t = t0 + 32 * u + lane;
              if (t <= ed2) {
                merged[t] = mv[u];
                mscore[t] = ms[u];
              }
            }
          }
        }
        __syncwarp();
        if (disjoint) b0 = st2;
        if (!contained) b1 = ed2;
      }
    }
  }
  __syncthreads();

  // 7.
  const bool use_merged = n_kept > 0 && count > 0;
  for (int t = tid; t < F; t += kThreads) {
    o[t] = use_merged ? merged[t] : s2[t];
  }
}

template <typename T, int NS>
int launch(const void* step2, const void* cands, const void* scores,
           void* out, void* iscratch, void* fscratch, int B, int F, int S,
           int kmax, double allowed, cudaStream_t stream) {
  auto kernel = harvest_fix_step3_kernel<T, NS>;
  const size_t merge_bytes = 2 * static_cast<size_t>(F) * sizeof(T);
  const bool in_smem = merge_bytes <= static_cast<size_t>(kSmemMax);
  const int smem = in_smem ? static_cast<int>(merge_bytes) : 0;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The most blocks a row, up to kCluster, at which the card holds every
  // row's cluster at once (a row that waits for another's cluster to end
  // doubles the time); one where even that is too many.
  for (int c = kCluster;; c /= 2) {
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(B * c);
    int n = 0;
    if (c == 1) break;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
    } else if (n >= B) {
      break;
    }
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(step2),
      static_cast<const T*>(cands), static_cast<const T*>(scores),
      static_cast<T*>(out), static_cast<int*>(iscratch),
      static_cast<T*>(fscratch), F, S, kmax, static_cast<T>(allowed),
      in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Slots a lane holds: ceil(S / 32) up to 4, the loops unrolled; 0 (a
// general loop) beyond 128 slots.
template <typename T>
int launch_slots(const void* step2, const void* cands, const void* scores,
                 void* out, void* iscratch, void* fscratch, int B, int F,
                 int S, int kmax, double allowed, cudaStream_t stream) {
  switch ((S + 31) / 32) {
    case 1:
      return launch<T, 1>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, stream);
    case 2:
      return launch<T, 2>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, stream);
    case 3:
      return launch<T, 3>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, stream);
    case 4:
      return launch<T, 4>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, stream);
    default:
      return launch<T, 0>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, stream);
  }
}

}  // namespace

// step2 and out: contiguous (B, F); cands and scores: contiguous
// (B, F, S); all float (elt_bytes 4) or double (8).  iscratch: B rows of
// 3 + 7 * kmax int32; fscratch: B rows of (4 * 101 + 1) * kmax + 4 * F
// elements of the same type (ops/contour.py: harvest_scratch).  kmax >= 1
// sections are handled, the first kmax of a row.  Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for an unknown element size).
extern "C" int harvest_fix_step3_launch(int elt_bytes, const void* step2,
                                        const void* cands,
                                        const void* scores, void* out,
                                        void* iscratch, void* fscratch,
                                        int B, int F, int S, int kmax,
                                        double allowed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0) return 0;
  if (S <= 0 || kmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (elt_bytes == 4) {
    return launch_slots<float>(step2, cands, scores, out, iscratch,
                               fscratch, B, F, S, kmax, allowed, s);
  }
  if (elt_bytes == 8) {
    return launch_slots<double>(step2, cands, scores, out, iscratch,
                                fscratch, B, F, S, kmax, allowed, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
