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
// Bound: the chain.  A row's walk is one dependent sequence (each active
// frame's reference depends on the last two values), two divides deep per
// active frame; bytes (step2, cands and the output, once each) are far
// below it.
//
// Design.  One block per row; one thread (thread 0) walks it, as a row has
// nothing to share out: C = 7 bands at the default options.  The block's
// other threads stage the walk's frames into shared memory, kTile frames
// at a time, each band's frames read contiguously from the (B, C, F)
// layout the band stage writes (no transposed copy); thread 0 then reads
// the frame's C candidates from shared memory.  FixStep4 starts after
// FixStep3 in the same thread, reading FixStep3's values back from the
// output row, so no barrier across blocks is needed.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;              // frames staged per tile
constexpr int kSmemDefault = 48 * 1024;  // no opt-in needed below this

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
    const T v = c[k * stride];
    const T e = fabs(Rn<T>::sub(reference, v));
    if (!isnan(best_err) && (isnan(e) || e < best_err)) {
      best = v;
      best_err = e;
    }
  }
  const T ratio = Rn<T>::div(best, reference);
  return fabs(Rn<T>::sub(T(1), ratio)) > allowed ? T(0) : best;
}

// Stages frames [t0, t0 + n) of the row: every band's candidates into
// s_c[band * tile + j], step2 into s_v, and (step4) the output row into
// s_o.
template <typename T>
__device__ void stage(const T* cr, const T* s2, const T* o, T* s_c, T* s_v,
                      T* s_o, int C, int F, int tile, int t0, int n) {
  for (int i = threadIdx.x; i < C * tile; i += kThreads) {
    const int c = i / tile, j = i - c * tile;
    if (j < n) s_c[i] = cr[static_cast<size_t>(c) * F + t0 + j];
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s_v[j] = s2[t0 + j];
    if (s_o != nullptr) s_o[j] = o[t0 + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dio_fix_kernel(const T* __restrict__ step2, const T* __restrict__ cands,
               T* out, int C, int F, int tile, T allowed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_c = reinterpret_cast<T*>(smem_raw);   // [C][tile]
  T* s_v = s_c + C * tile;                   // step2, [tile]
  T* s_o = s_v + tile;                       // FixStep3's values, [tile]
  const size_t row = blockIdx.x;
  const T* s2 = step2 + row * F;
  const T* cr = cands + row * C * static_cast<size_t>(F);
  T* o = out + row * F;
  const bool walker = threadIdx.x == 0;

  // FixStep3, forward.  Thread 0's state: the last two values, whether
  // the walk is active, whether step2 was voiced at the frame before.
  T prev1 = s2[0], prev2 = T(0);
  bool active = false, voiced_before = s2[0] != T(0);
  if (walker) o[0] = s2[0];
  for (int t0 = 1; t0 < F; t0 += tile) {
    const int n = min(tile, F - t0);
    __syncthreads();                           // the last tile is used up
    stage(cr, s2, o, s_c, s_v, static_cast<T*>(nullptr), C, F, tile, t0, n);
    __syncthreads();
    if (walker) {
      for (int j = 0; j < n; ++j) {
        const T v2 = s_v[j];
        const bool voiced = v2 != T(0);
        active = active || (voiced_before && !voiced);
        voiced_before = voiced;
        const T val =
            active ? select_best(prev1, prev2, s_c + j, tile, C, allowed)
                   : v2;
        active = active && val != T(0);
        prev2 = prev1;
        prev1 = val;
        o[t0 + j] = val;
      }
    }
  }

  // FixStep4, backward over FixStep3's values (the output row, written
  // by this block's thread 0 before the barrier that opens each tile).
  if (F < 2) return;
  T next1 = walker ? o[F - 1] : T(0), next2 = T(0);
  bool voiced_after = s2[F - 1] != T(0);
  active = false;
  for (int t1 = F - 1; t1 > 0; t1 -= tile) {   // frames [t1 - n, t1)
    const int n = min(tile, t1);
    const int t0 = t1 - n;
    __syncthreads();
    stage(cr, s2, o, s_c, s_v, s_o, C, F, tile, t0, n);
    __syncthreads();
    if (walker) {
      for (int j = n - 1; j >= 0; --j) {
        const int t = t0 + j;
        const bool voiced = s_v[j] != T(0);
        active = active || (!voiced && voiced_after);
        voiced_after = voiced;
        const T val =
            (t > 0 && active)
                ? select_best(next1, next2, s_c + j, tile, C, allowed)
                : s_o[j];
        active = active && val != T(0);
        next2 = next1;
        next1 = val;
        o[t] = val;
      }
    }
  }
}

template <typename T>
int launch(const void* step2, const void* cands, void* out, int B, int C,
           int F, double allowed, cudaStream_t stream) {
  // Frames per tile: kTile, fewer where many bands would pass the shared
  // memory a block gets without opting in.
  const int per_frame = (C + 2) * static_cast<int>(sizeof(T));
  const int tile = std::min(kTile, kSmemDefault / per_frame);
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  dio_fix_kernel<T><<<B, kThreads, tile * per_frame, stream>>>(
      static_cast<const T*>(step2), static_cast<const T*>(cands),
      static_cast<T*>(out), C, F, tile, static_cast<T>(allowed));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// step2 and out: contiguous (B, F); cands: contiguous (B, C, F); all float
// (elt_bytes 4) or double (8).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown element size or too many bands).
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
