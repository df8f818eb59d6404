// Dio's contour walks, FixStep3 then FixStep4 (src/dio.cpp:215-253), CUDA
// C++ for sm_90a.
//
// Replaces the JAX package's two lax.scan walks
// (world_tpu/models/dio.py:155-203), which the port's plain version runs
// as Python loops over frames (world_tpu_torch/models/dio.py: _fix_step3,
// _fix_step4; a few dozen launches per frame).  Per row:
//   FixStep3 walks forward from frame 1.  A voiced->unvoiced boundary of
//   step2 (t-1 voiced, t not) makes the walk active; an active frame takes
//   SelectBestF0(prev1, prev2, cands[:, t]), an inactive one keeps
//   step2[t]; a zero value ends the activity.
//   FixStep4 walks backward from frame F-2 over FixStep3's values, active
//   from each unvoiced->voiced boundary of step2 (t unvoiced, t+1 voiced);
//   frame 0 is never rewritten.
// SelectBestF0: reference = (current * 3 - past) / 2; the candidate with
// the least |reference - c| (the first of equal minima, and a NaN error
// counting as the minimum, as torch.argmin has it); zero when
// |1 - best / reference| > allowed_range (a NaN ratio keeps best).
// Each operation rounds on its own, as the plain version's tensor ops do:
// the multiply and subtract of the reference are the intrinsics that
// nvcc never contracts into an FMA (the source is also built with
// -fmad=false), and the divisions are IEEE.  So the kernel equals the
// plain version bit for bit.
//
// Bound: the chain.  A row's walk is one dependent sequence through its
// active frames (each one's reference depends on the last two values),
// two divides deep per active frame; bytes (step2, cands and the output,
// once each) are far below it.  Only a few frames of a row are active, so
// in practice the launch sets the floor.
//
// Design.  One block per row.  The block stages the row once in shared
// memory: step2, the output row (step2's values to start with) and the C
// band rows, each read contiguously from the (B, C, F) layout the band
// stage writes, and it marks the walks' boundary frames in two bit masks
// by ballots.  A row whose bands do not fit in shared memory leaves them
// in device memory (then the rows too where those do not fit, and the
// masks last, where the walker tests step2 frame by frame).  One thread
// then walks only the active runs: from each boundary that no earlier run
// covered (__ffs over the masks) until a zero is selected, reading the
// last two values from the row.  FixStep4 works in place on the row that
// FixStep3 left, from the top boundary down.  The block writes the row
// once, coalesced.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemDefault = 48 * 1024;  // no opt-in needed below this

// What a row keeps in shared memory, each level adding to the last.
enum Level { kNothing = 0, kMasks = 1, kRows = 2, kBands = 3 };

template <typename T> struct Rn;
template <> struct Rn<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Rn<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
};

// SelectBestF0 over the C candidates c[0], c[stride], ...
template <typename T>
__device__ T select_best(T current, T past, const T* c, int stride, int C,
                         T allowed) {
  const T reference =
      Rn<T>::div(Rn<T>::sub(Rn<T>::mul(current, T(3)), past), T(2));
  T best = c[0];
  T best_err = fabs(Rn<T>::sub(reference, best));
  for (int k = 1; k < C; ++k) {
    const T v = c[static_cast<size_t>(k) * stride];
    const T e = fabs(Rn<T>::sub(reference, v));
    if (!isnan(best_err) && (isnan(e) || e < best_err)) {
      best = v;
      best_err = e;
    }
  }
  const T ratio = Rn<T>::div(best, reference);
  return fabs(Rn<T>::sub(T(1), ratio)) > allowed ? T(0) : best;
}

// FixStep3 starts at t (t-1 voiced, t not); FixStep4 at t > 0 (t
// unvoiced, t+1 voiced).
template <typename T>
__device__ bool start3(const T* s2, int t, int F) {
  return t >= 1 && t < F && s2[t - 1] != T(0) && s2[t] == T(0);
}
template <typename T>
__device__ bool start4(const T* s2, int t, int F) {
  return t >= 1 && t + 1 < F && s2[t] == T(0) && s2[t + 1] != T(0);
}

// The first FixStep3 start at or after t (F if none): from the mask, or
// frame by frame where there is none.
template <typename T>
__device__ int next_start3(const unsigned* m, const T* s2, int t, int F) {
  if (m == nullptr) {
    while (t < F && !start3(s2, t, F)) ++t;
    return t;
  }
  const int words = (F + 31) / 32;
  int w = t >> 5;
  if (w >= words) return F;
  unsigned bits = m[w] & (~0u << (t & 31));
  while (bits == 0) {
    if (++w >= words) return F;
    bits = m[w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

// The last FixStep4 start at or before t (0 if none).
template <typename T>
__device__ int prev_start4(const unsigned* m, const T* s2, int t, int F) {
  if (m == nullptr) {
    while (t >= 1 && !start4(s2, t, F)) --t;
    return max(t, 0);
  }
  if (t < 1) return 0;
  int w = t >> 5;
  unsigned bits = m[w] & (~0u >> (31 - (t & 31)));
  while (bits == 0) {
    if (--w < 0) return 0;
    bits = m[w];
  }
  return (w << 5) + 31 - __clz(bits);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dio_fix_kernel(const T* __restrict__ step2, const T* __restrict__ cands,
               T* out, int C, int F, int level, T allowed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t row = blockIdx.x;
  const T* s2g = step2 + row * F;
  const T* cg = cands + row * C * static_cast<size_t>(F);
  T* og = out + row * F;
  const int words = (F + 31) / 32;
  // Shared memory: the masks (an even word count keeps the rows aligned),
  // then step2 and the output row, then the bands.
  unsigned* m3 = level >= kMasks ? reinterpret_cast<unsigned*>(smem_raw)
                                 : nullptr;
  unsigned* m4 = level >= kMasks ? m3 + words : nullptr;
  T* s2s = reinterpret_cast<T*>(smem_raw + 4 * 2 * ((words + 1) & ~1));
  const T* s2 = level >= kRows ? s2s : s2g;
  T* r = level >= kRows ? s2s + F : og;
  T* cs = s2s + 2 * static_cast<size_t>(F);
  const T* c = level >= kBands ? cs : cg;

  for (int t = threadIdx.x; t < F; t += kThreads) {
    const T v = s2g[t];
    if (level >= kRows) s2s[t] = v;
    r[t] = v;
  }
  if (level >= kBands) {
    for (int i = threadIdx.x; i < C * F; i += kThreads) cs[i] = cg[i];
  }
  if (level >= kMasks) {
    const int lane = threadIdx.x & 31;
    for (int w = threadIdx.x >> 5; w < words; w += kThreads / 32) {
      const int t = 32 * w + lane;
      const unsigned b3 = __ballot_sync(0xffffffffu, start3(s2g, t, F));
      const unsigned b4 = __ballot_sync(0xffffffffu, start4(s2g, t, F));
      if (lane == 0) {
        m3[w] = b3;
        m4[w] = b4;
      }
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // FixStep3: each run from a start no earlier run reached, until a
    // zero is selected; t is the first frame no run has decided.
    int t = 1, b;
    while ((b = next_start3(m3, s2, t, F)) < F) {
      T p1 = r[b - 1], p2 = b >= 2 ? r[b - 2] : T(0), v;
      int u = b;
      do {
        v = select_best(p1, p2, c + u, F, C, allowed);
        r[u++] = v;
        p2 = p1;
        p1 = v;
      } while (v != T(0) && u < F);
      t = u;
    }
    // FixStep4, in place: each run from a start no later run reached,
    // down to a zero or frame 1.
    t = F - 2;
    while ((b = prev_start4(m4, s2, t, F)) >= 1) {
      T n1 = r[b + 1], n2 = b + 2 < F ? r[b + 2] : T(0), v;
      int u = b;
      do {
        v = select_best(n1, n2, c + u, F, C, allowed);
        r[u--] = v;
        n2 = n1;
        n1 = v;
      } while (v != T(0) && u >= 1);
      t = u;
    }
  }
  if (level >= kRows) {
    __syncthreads();
    for (int t = threadIdx.x; t < F; t += kThreads) og[t] = r[t];
  }
}

template <typename T>
int launch(const void* step2, const void* cands, void* out, int B, int C,
           int F, double allowed, cudaStream_t stream) {
  int device = 0, most = kSmemDefault;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t words = (static_cast<size_t>(F) + 31) / 32;
  const size_t masks = 4 * 2 * ((words + 1) & ~size_t(1));
  const size_t rows = masks + 2 * static_cast<size_t>(F) * sizeof(T);
  const size_t bands = rows + static_cast<size_t>(C) * F * sizeof(T);
  const size_t cap = static_cast<size_t>(most);
  const int level = bands <= cap ? kBands : rows <= cap ? kRows
                    : masks <= cap ? kMasks : kNothing;
  const size_t smem = level == kBands ? bands : level == kRows ? rows
                      : level == kMasks ? masks : 0;
  if (smem > static_cast<size_t>(kSmemDefault)) {
    e = cudaFuncSetAttribute(
        dio_fix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dio_fix_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(step2), static_cast<const T*>(cands),
      static_cast<T*>(out), C, F, level, static_cast<T>(allowed));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// step2 and out: contiguous (B, F); cands: contiguous (B, C, F); all float
// (elt_bytes 4) or double (8).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown element size).
extern "C" int dio_fix_launch(int elt_bytes, const void* step2,
                              const void* cands, void* out, int B, int C,
                              int F, double allowed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (elt_bytes == 4) return launch<float>(step2, cands, out, B, C, F,
                                           allowed, s);
  if (elt_bytes == 8) return launch<double>(step2, cands, out, B, C, F,
                                            allowed, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
