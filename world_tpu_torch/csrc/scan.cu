// Sequential prefix sum along each row, CUDA C++ for sm_90a.
//
// Batch synthesis places its pulses by a running sum of per-sample phase
// increments (GetPulseLocationsForTimeBase in src/synthesis.cpp), and the
// reference adds them one after another.  Where the sum ties a period
// boundary (every 441 samples of the 500 Hz unvoiced default at 22.05
// kHz) its rounding decides where a pulse falls, and so the noise stream
// of every later pulse: a parallel scan, which adds in another order,
// moves pulses.  This kernel adds in the reference's order:
// y[b, i] = x[b, 0] + ... + x[b, i], summed from zero one element after
// another in double precision and rounded to the row's dtype on each
// write.  That is bit for bit the plain version
// (world_tpu_torch/ops/scan.py: torch.cumsum of the float64 row on the
// CPU, a sequential loop), and for float64 rows numpy's cumsum.
//
// Bound: the chain.  Each row is one dependent chain of L double adds, so a
// row takes L add latencies whatever the width of the card; bytes (each
// element read and written once) and the count of adds are far below.
//
// Design.  One block of 256 threads per row.  The row goes through shared
// memory in chunks of kChunk elements, double-buffered: while thread 0
// sums chunk c from one buffer into its output buffer, warps 1-7 write
// chunk c-1's sums to global memory and load chunk c+1, both coalesced.
// Both buffers hold doubles whatever the row's dtype: warps 1-7 convert
// on the way in and out, so thread 0's loop is the same for float and
// double rows (converting float rows in thread 0 made them slower than
// double rows; PERF.md).  Thread 0 reads kGroup inputs into
// registers before their adds, so the shared-memory latency is paid once
// per group and the adds issue back to back.  Elements past the row's
// end are loaded as zero and not written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;    // elements per shared-memory chunk
constexpr int kGroup = 32;      // inputs read into registers per group

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int L) {
  __shared__ double in_s[2][kChunk];
  __shared__ double out_s[2][kChunk];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * L;
  T* yr = y + static_cast<size_t>(blockIdx.x) * L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const int loader = static_cast<int>(threadIdx.x) - 32;   // warps 1-7
  constexpr int kLoaders = kThreads - 32;

  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    in_s[0][i] = i < L ? static_cast<double>(xr[i]) : 0.0;
  }
  __syncthreads();

  double acc = 0.0;
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    if (threadIdx.x == 0) {
      const double* src = in_s[b];
      double* dst = out_s[b];
      for (int i = 0; i < kChunk; i += kGroup) {
        double v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[k] = src[i + k];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          acc += v[k];
          dst[i + k] = acc;
        }
      }
    } else if (loader >= 0) {
      const int nb = b ^ 1;
      if (c > 0) {                       // chunk c-1's sums, out to global
        const int base = (c - 1) * kChunk;
        for (int i = loader; i < kChunk; i += kLoaders) {
          // c-1 < n_chunks-1: all in range
          yr[base + i] = static_cast<T>(out_s[nb][i]);
        }
      }
      if (c + 1 < n_chunks) {            // chunk c+1, in from global
        const int base = (c + 1) * kChunk;
        for (int i = loader; i < kChunk; i += kLoaders) {
          in_s[nb][i] = base + i < L ? static_cast<double>(xr[base + i])
                                     : 0.0;
        }
      }
    }
    __syncthreads();
  }
  const int last = n_chunks - 1;
  if (last >= 0) {
    const int base = last * kChunk;
    for (int i = threadIdx.x; i < kChunk && base + i < L; i += kThreads) {
      yr[base + i] = static_cast<T>(out_s[last & 1][i]);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int B, int L, cudaStream_t stream) {
  scan_rows_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y: contiguous (B, L) rows of float (elt_bytes 4) or double (8).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unknown element size).
extern "C" int scan_rows_launch(int elt_bytes, const void* x, void* y, int B,
                                int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0) return 0;
  if (elt_bytes == 4) return launch<float>(x, y, B, L, s);
  if (elt_bytes == 8) return launch<double>(x, y, B, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
