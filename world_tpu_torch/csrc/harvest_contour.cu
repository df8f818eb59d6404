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
// once each) are far below it.
//
// Design.  One block of kWarps warps per row.  One warp per walk (section
// and direction), its lanes over the S candidate slots: a warp reduction
// gives SelectBestF0 and the frame score of the value it picked, and the
// walks of a row run side by side, kWarps at a time.  A section's values
// are kept compactly: its step2 interior is read from step2, the two
// walks' values and frame scores go in 101-entry lists in the row's
// scratch.  The merged row and its scores live in shared memory where 2F
// values fit under kSmemMax, else in the scratch.  The section count K is
// found in the kernel (no host sync); the scratch holds kmax sections.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 101;                 // walk steps, 100-frame threshold
constexpr int kLists = 6;                   // int lists per row, kmax each
constexpr int kSmemMax = 160 * 1024;        // merged row + scores in smem
constexpr int kSmemDefault = 48 * 1024;     // no opt-in needed below this
constexpr unsigned kFull = 0xffffffffu;

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

// Whether slot error ea (slot ia) beats eb (slot ib) in SelectBestF0's
// argmin: a NaN error is the minimum, then the smaller error, then the
// later slot.  Slot -1 is a lane with no slot left.
template <typename T>
__device__ bool beats(T ea, int ia, T eb, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = isnan(ea), nb = isnan(eb);
  if (na != nb) return na;
  if (!na && ea != eb) return ea < eb;
  return ia > ib;
}

// torch.amax's maximum: a NaN wins.
template <typename T>
__device__ T max_nan(T a, T b) {
  return isnan(a) ? a : (isnan(b) || b > a) ? b : a;
}

template <typename T>
__device__ T warp_max(T m) {
  for (int off = 16; off > 0; off >>= 1) {
    m = max_nan(m, __shfl_xor_sync(kFull, m, off));
  }
  return m;
}

// The best score among the S slots of a frame whose candidate equals v
// (0 where a slot's candidate differs), a warp over the slots.
template <typename T>
__device__ T frame_score(const T* c, const T* s, int S, T v, int lane) {
  T m = -static_cast<T>(INFINITY);
  for (int j = lane; j < S; j += 32) m = max_nan(m, c[j] == v ? s[j] : T(0));
  return warp_max(m);
}

// One row's sections: the plain version's multi[k, t] and
// frame_score[k, t] read back from the compact lists.
template <typename T>
struct Sections {
  const T* s2;
  const int *st, *ed, *nst, *ned;   // step2's bounds; extended bounds
  const T *val, *score;             // [2k + (left)][step]
  const T *in_score, *zero_score;   // frame scores of step2's value, of 0

  __device__ T value(int k, int t) const {
    if (t < nst[k] || t > ned[k]) return T(0);
    if (t > ed[k]) return T(0) + val[2 * k * kSteps + t - ed[k] - 1];
    if (t < st[k]) return T(0) + val[(2 * k + 1) * kSteps + st[k] - t - 1];
    return s2[t];
  }
  __device__ T frame(int k, int t) const {
    if (t < nst[k] || t > ned[k]) return zero_score[t];
    if (t > ed[k]) return score[2 * k * kSteps + t - ed[k] - 1];
    if (t < st[k]) return score[(2 * k + 1) * kSteps + st[k] - t - 1];
    return in_score[t];
  }
};

// GetBoundaryList's voicing: frames 0 and F-1 count as unvoiced.
template <typename T>
__device__ bool voiced_at(const T* s2, int j, int F) {
  return j > 0 && j < F - 1 && s2[j] != T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
harvest_fix_step3_kernel(const T* __restrict__ step2,
                         const T* __restrict__ cands,
                         const T* __restrict__ scores, T* out,
                         int* iscratch, T* fscratch, int F, int S, int kmax,
                         T allowed, bool merge_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sh_count, sh_k, sh_kept, sh_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const T* s2 = step2 + row * F;
  const T* cr = cands + row * F * static_cast<size_t>(S);
  const T* sr = scores + row * F * static_cast<size_t>(S);
  T* o = out + row * F;
  int* st = iscratch + row * kLists * kmax;
  int* ed = st + kmax;
  int* nst = ed + kmax;
  int* ned = nst + kmax;
  int* kept = ned + kmax;
  int* order = kept + kmax;
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

  // 1. Section bounds, warp 0: ballots over 32 frames at a time.
  if (warp == 0) {
    int n_st = 0, n_ed = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < F; base += 32) {
      const int j = base + lane;
      const bool v = voiced_at(s2, j, F);
      const bool is_st = v && !voiced_at(s2, j - 1, F);
      const bool is_ed = v && !voiced_at(s2, j + 1, F);
      const unsigned ms = __ballot_sync(kFull, is_st);
      const unsigned me = __ballot_sync(kFull, is_ed);
      const int ps = n_st + __popc(ms & below);
      const int pe = n_ed + __popc(me & below);
      if (is_st && ps < kmax) st[ps] = j;
      if (is_ed && pe < kmax) ed[pe] = j;
      n_st += __popc(ms);
      n_ed += __popc(me);
    }
    if (lane == 0) {
      sh_count = n_st;
      sh_k = min(n_st, kmax);
    }
  }
  __syncthreads();
  const int K = sh_k;

  // 2. ExtendF0: walk q is section q / 2, rightward for even q.  Each
  // step's frame score is kept beside its value (5.).
  for (int q = warp; q < 2 * K; q += kWarps) {
    const int k = q >> 1;
    const int dir = (q & 1) ? -1 : 1;
    const int origin = dir > 0 ? ed[k] : st[k];
    const int last = dir > 0 ? min(origin + 100, F - 2)
                             : max(origin - 100, 1);
    const int n_steps = min(abs(last - origin) + 1, kSteps);
    T* vals = val + q * kSteps;
    T* fss = score + q * kSteps;
    T ref = s2[origin];
    int misses = 0, shifted = origin;
    for (int s = 0; s < n_steps && misses < 4; ++s) {
      const int t = origin + dir * (s + 1);
      const bool inside = t >= 0 && t < F;
      const T* c = cr + static_cast<size_t>(t) * S;
      T e = T(0), cv = T(0);
      int i = -1;
      for (int j = lane; j < S; j += 32) {
        const T cj = inside ? c[j] : T(0);
        const T ej = Rn<T>::div(fabs(Rn<T>::sub(ref, cj)), ref);
        if (beats(ej, j, e, i)) {
          e = ej;
          i = j;
          cv = cj;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T e2 = __shfl_xor_sync(kFull, e, off);
        const int i2 = __shfl_xor_sync(kFull, i, off);
        const T c2 = __shfl_xor_sync(kFull, cv, off);
        if (beats(e2, i2, e, i)) {
          e = e2;
          i = i2;
          cv = c2;
        }
      }
      const T v = (i >= 0 && e <= allowed) ? cv : T(0);
      if (v != T(0)) {
        ref = v;
        shifted = t;
        misses = 0;
      } else {
        ++misses;
      }
      const T fs = inside
          ? frame_score(c, sr + static_cast<size_t>(t) * S, S, v, lane)
          : T(0);
      if (lane == 0) {
        vals[s] = v;
        fss[s] = fs;
      }
    }
    if (lane == 0) (dir > 0 ? ned : nst)[k] = shifted;
  }

  // 5. (inside the sections) The frame scores of step2's value and of 0
  // at every frame, a warp per frame.
  for (int t = warp; t < F; t += kWarps) {
    const T* c = cr + static_cast<size_t>(t) * S;
    const T* sc = sr + static_cast<size_t>(t) * S;
    const T v = s2[t];
    T mv = -static_cast<T>(INFINITY), mz = mv;
    for (int j = lane; j < S; j += 32) {
      const T cj = c[j], sj = sc[j];
      mv = max_nan(mv, cj == v ? sj : T(0));
      mz = max_nan(mz, cj == T(0) ? sj : T(0));
    }
    mv = warp_max(mv);
    mz = warp_max(mz);
    if (lane == 0) {
      in_score[t] = mv;
      zero_score[t] = mz;
    }
  }
  __syncthreads();

  // 3. ExtendSub: each section's sum in frame order, a thread each; then
  // the mean carried over the sections in order, and the kept list.
  for (int k = tid; k < K; k += kThreads) {
    T acc = T(0);
    for (int t = nst[k]; t < ned[k]; ++t) {
      acc = Rn<T>::add(acc, sec.value(k, t));
    }
    sums[k] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    T mean = T(0);
    int n = 0;
    for (int k = 0; k < K; ++k) {
      const T len = static_cast<T>(ned[k] - nst[k]);
      mean = Rn<T>::div(Rn<T>::add(mean, sums[k]), len);
      if (Rn<T>::mul(Rn<T>::rcp(mean), T(2200)) < len) kept[n++] = k;
    }
    sh_kept = n;
  }
  __syncthreads();
  const int n_kept = sh_kept;

  // 4. The kept sections' ranks by new start, ties in kept order.
  for (int i = tid; i < n_kept; i += kThreads) {
    const int key = nst[kept[i]];
    int r = 0;
    for (int j = 0; j < n_kept; ++j) {
      const int kj = nst[kept[j]];
      r += kj < key || (kj == key && j < i);
    }
    order[r] = i;
  }

  // 6. MergeF0 from the first kept section.
  if (n_kept > 0) {
    const int k0 = kept[0];
    for (int t = tid; t < F; t += kThreads) {
      merged[t] = sec.value(k0, t);
      mscore[t] = sec.frame(k0, t);
    }
  }
  __syncthreads();
  int b0 = n_kept > 0 ? nst[kept[0]] : 0;
  int b1 = n_kept > 0 ? ned[kept[0]] : 0;
  for (int i = 1; i < n_kept; ++i) {
    const int k = kept[order[i]];
    const int st2 = nst[k], ed2 = ned[k];
    const bool disjoint = st2 - b1 > 0;
    const bool contained = b0 <= st2 && b1 >= ed2;
    int from = st2;
    if (!disjoint && !contained) {
      if (tid == 0) {
        T score1 = T(0), score2 = T(0);
        for (int t = st2; t <= b1; ++t) {
          score1 = Rn<T>::add(score1, mscore[t]);
          score2 = Rn<T>::add(score2, sec.frame(k, t));
        }
        sh_lo = score1 > score2 ? b1 : st2;
      }
      __syncthreads();
      from = sh_lo;
    }
    if (!contained) {
      for (int t = from + tid; t <= ed2; t += kThreads) {
        merged[t] = sec.value(k, t);
        mscore[t] = sec.frame(k, t);
      }
    }
    __syncthreads();
    if (disjoint) b0 = st2;
    if (!contained) b1 = ed2;
  }

  // 7.
  const bool use_merged = n_kept > 0 && sh_count > 0;
  for (int t = tid; t < F; t += kThreads) {
    o[t] = use_merged ? merged[t] : s2[t];
  }
}

template <typename T>
int launch(const void* step2, const void* cands, const void* scores,
           void* out, void* iscratch, void* fscratch, int B, int F, int S,
           int kmax, double allowed, cudaStream_t stream) {
  const size_t merge_bytes = 2 * static_cast<size_t>(F) * sizeof(T);
  const bool in_smem = merge_bytes <= static_cast<size_t>(kSmemMax);
  const int smem = in_smem ? static_cast<int>(merge_bytes) : 0;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        harvest_fix_step3_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  harvest_fix_step3_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(step2), static_cast<const T*>(cands),
      static_cast<const T*>(scores), static_cast<T*>(out),
      static_cast<int*>(iscratch), static_cast<T*>(fscratch), F, S, kmax,
      static_cast<T>(allowed), in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// step2 and out: contiguous (B, F); cands and scores: contiguous
// (B, F, S); all float (elt_bytes 4) or double (8).  iscratch: B rows of
// 6 * kmax int32; fscratch: B rows of (4 * 101 + 1) * kmax + 4 * F
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
    return launch<float>(step2, cands, scores, out, iscratch, fscratch, B,
                         F, S, kmax, allowed, s);
  }
  if (elt_bytes == 8) {
    return launch<double>(step2, cands, scores, out, iscratch, fscratch, B,
                          F, S, kmax, allowed, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
