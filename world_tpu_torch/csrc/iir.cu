// Causal IIR recurrences run forward and backward (zero phase) in float64,
// and the block-LTI form's carried state, CUDA C++ for sm_90a.
//
// iir_zero_phase replaces the JAX package's float64 lax.scans of
// decimate's filter (world_tpu/ops/matlab.py:204-227) and of Harvest's
// smoothing biquad (world_tpu/models/harvest_contour.py:353-366), which
// the port's plain versions run as Python loops over samples
// (world_tpu_torch/ops/matlab.py: _filter_for_decimate;
// world_tpu_torch/models/harvest_contour.py: _biquad; a dozen launches a
// sample).  Per lane it computes flip(f(flip(f(x)))) in one launch, f
// one of two recurrences from a zero state:
//   decimate's 3rd-order direct-form-II stage (src/matlabfunctions.cpp:
//   27-125):  wt = xi + a0*w0 + a1*w1 + a2*w2,
//             y  = b0*wt + b1*w0 + b1*w1 + b0*w2;
//   the smoothing biquad, direct form I (src/harvest.cpp:1058-1085):
//             y  = b0*x + b1*x1 + b0*x2 + a0*y1 + a1*y2.
// Each sum is taken left to right and every product and sum rounds on its
// own (the _rn intrinsics, and the source is built with -fmad=false), as
// the plain version's separate tensor ops do, so the kernel equals it bit
// for bit.
//
// lti_state_scan replaces the lax.scan of lti_block_filter
// (world_tpu/ops/matlab.py:167-187), a Python loop over 128-sample blocks
// in the port: states[j] = s, then s = AL s + p[j], from s = 0.  Row i of
// AL s + p[j] is ((s0*AL[i,0] + s1*AL[i,1]) + ...) + p[j,i], the order of
// the plain version (world_tpu_torch/ops/iir.py: lti_state_scan_plain).
//
// Bound: the chain.  A lane is one dependent sequence: per sample, through
// w0, one multiply and three adds (decimate), through y1 one multiply and
// two adds (the biquad); per block, one multiply and S adds.  No order-
// keeping version beats length x 2 passes x that latency
// (tools/iir_chain.cu measures it); bytes and operations are far below.
// A lane cannot be split without reassociating, so a call of few lanes
// (decimate's one row in analyze()) leaves the card nearly empty.
//
// Design.  One thread walks one lane, keeping the recurrence's state in
// registers.  The inputs of the next kGroup samples are loaded into
// registers before the current group's steps, so their latency hides
// behind the chain.  The forward pass writes f(x) to the output; the
// backward pass reads it from the end and writes its result in place at
// the same index, so no flipped copy is made.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 16;      // samples loaded ahead of their steps

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// c = (a0, a1, a2, b0, b1) of _DECIMATE_COEFFS[r].
struct Decimate {
  double a0, a1, a2, b0, b1;
  double w0, w1, w2;
  __device__ Decimate(const double* c)
      : a0(c[0]), a1(c[1]), a2(c[2]), b0(c[3]), b1(c[4]),
        w0(0.0), w1(0.0), w2(0.0) {}
  __device__ __forceinline__ double step(double xi) {
    const double wt = add_rn(add_rn(add_rn(xi, mul_rn(a0, w0)),
                                    mul_rn(a1, w1)),
                             mul_rn(a2, w2));
    const double y = add_rn(add_rn(add_rn(mul_rn(b0, wt), mul_rn(b1, w0)),
                                   mul_rn(b1, w1)),
                            mul_rn(b0, w2));
    w2 = w1;
    w1 = w0;
    w0 = wt;
    return y;
  }
};

// c = (b0, b1, a0, a1) of the smoothing biquad.
struct Biquad {
  double b0, b1, a0, a1;
  double x1, x2, y1, y2;
  __device__ Biquad(const double* c)
      : b0(c[0]), b1(c[1]), a0(c[2]), a1(c[3]),
        x1(0.0), x2(0.0), y1(0.0), y2(0.0) {}
  __device__ __forceinline__ double step(double xt) {
    const double y = add_rn(add_rn(add_rn(add_rn(mul_rn(b0, xt),
                                                 mul_rn(b1, x1)),
                                          mul_rn(b0, x2)),
                                   mul_rn(a0, y1)),
                            mul_rn(a1, y2));
    x2 = x1;
    x1 = xt;
    y2 = y1;
    y1 = y;
    return y;
  }
};

// One pass of f over src[at(0)], src[at(1)], ..., writing dst[at(k)],
// with at(k) = k (forward) or n - 1 - k (backward).  src and dst may be
// the same row: every group is loaded before it is written, and the next
// group's loads touch other indices.
template <class F, bool kBackward>
__device__ void pass(F f, const double* src, double* dst, long long n) {
  double cur[kGroup], nxt[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const long long i = k;
    cur[k] = i < n ? src[kBackward ? n - 1 - i : i] : 0.0;
  }
  for (long long base = 0; base < n; base += kGroup) {
    const long long next = base + kGroup;
    if (next < n) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const long long i = next + k;
        nxt[k] = i < n ? src[kBackward ? n - 1 - i : i] : 0.0;
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const long long i = base + k;
      if (i < n) dst[kBackward ? n - 1 - i : i] = f.step(cur[k]);
    }
    if (next < n) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    }
  }
}

template <class F>
__global__ void __launch_bounds__(kThreads)
zero_phase_kernel(const double* __restrict__ x, double* y, int lanes,
                  long long n, const double c0, const double c1,
                  const double c2, const double c3, const double c4) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const double c[5] = {c0, c1, c2, c3, c4};
  const double* xr = x + static_cast<long long>(lane) * n;
  double* yr = y + static_cast<long long>(lane) * n;
  pass<F, false>(F(c), xr, yr, n);
  pass<F, true>(F(c), yr, yr, n);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(const T* __restrict__ p, const T* __restrict__ al,
                  T* __restrict__ states, int lanes, int nblk) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  T a[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int k = 0; k < S; ++k) a[i][k] = al[i * S + k];
  }
  const long long row = static_cast<long long>(lane) * nblk * S;
  const T* pr = p + row;
  T* sr = states + row;
  T s[S];
#pragma unroll
  for (int i = 0; i < S; ++i) s[i] = T(0);
#pragma unroll 4
  for (int j = 0; j < nblk; ++j) {
    T ns[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      sr[j * S + i] = s[i];
      T acc = mul_rn(s[0], a[i][0]);
#pragma unroll
      for (int k = 1; k < S; ++k) acc = add_rn(acc, mul_rn(s[k], a[i][k]));
      ns[i] = add_rn(acc, pr[j * S + i]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) s[i] = ns[i];
  }
}

int blocks(int lanes) { return (lanes + kThreads - 1) / kThreads; }

template <typename T, int S>
int launch_scan(const void* p, const void* al, void* states, int lanes,
                int nblk, cudaStream_t stream) {
  state_scan_kernel<T, S><<<blocks(lanes), kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(al),
      static_cast<T*>(states), lanes, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_of_state(int S, const void* p, const void* al, void* states,
                  int lanes, int nblk, cudaStream_t s) {
  switch (S) {
    case 1: return launch_scan<T, 1>(p, al, states, lanes, nblk, s);
    case 2: return launch_scan<T, 2>(p, al, states, lanes, nblk, s);
    case 3: return launch_scan<T, 3>(p, al, states, lanes, nblk, s);
    case 4: return launch_scan<T, 4>(p, al, states, lanes, nblk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: contiguous (lanes, n) float64 rows.  kind 0: decimate's stage,
// c = (a0, a1, a2, b0, b1); kind 1: the smoothing biquad, c = (b0, b1,
// a0, a1, unused).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown kind).
extern "C" int iir_zero_phase_launch(int kind, const void* x, void* y,
                                     int lanes, long long n, double c0,
                                     double c1, double c2, double c3,
                                     double c4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || n <= 0) return 0;
  const double* xd = static_cast<const double*>(x);
  double* yd = static_cast<double*>(y);
  if (kind == 0) {
    zero_phase_kernel<Decimate><<<blocks(lanes), kThreads, 0, s>>>(
        xd, yd, lanes, n, c0, c1, c2, c3, c4);
  } else if (kind == 1) {
    zero_phase_kernel<Biquad><<<blocks(lanes), kThreads, 0, s>>>(
        xd, yd, lanes, n, c0, c1, c2, c3, c4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, states: contiguous (lanes, nblk, S); al: contiguous (S, S); all float
// (elt_bytes 4) or double (8), 1 <= S <= 4.  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for another size or S).
extern "C" int lti_state_scan_launch(int elt_bytes, int S, const void* p,
                                     const void* al, void* states,
                                     int lanes, int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || nblk <= 0) return 0;
  if (elt_bytes == 4) {
    return scan_of_state<float>(S, p, al, states, lanes, nblk, s);
  }
  if (elt_bytes == 8) {
    return scan_of_state<double>(S, p, al, states, lanes, nblk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
