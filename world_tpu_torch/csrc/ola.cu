// Pitch-synchronous overlap-add for batch synthesis, CUDA C++ for sm_90a.
//
// Replaces world_tpu/ops/pallas_ola.py::_ola_kernel (the TPU kernel keeps
// a VMEM accumulator and adds each pulse with two vector rotates and one
// aligned read-modify-write).  Semantics, not the Mosaic shape: per batch
// row, a y_padded-sample output starts at zero and receives every pulse's
// fft-sample response at that pulse's offset, in pulse order.  Callers
// guarantee 0 <= offset <= y_padded - fft.
//
// Two index modes, chosen by the caller's arguments:
//   general  responses (B, P, fft), offsets (B, P) in any order; padded
//            pulses carry all-zero responses (the JAX signature).
//   ragged   responses (N, fft) of real pulses only, offsets (N,), CSR
//            row starts row_ptr (B+1,); offsets ascend within each row.
//
// Bound: bytes.  Each response sample is read once and each output sample
// written once; the arithmetic is one add per response sample.
//
// Design.  A block of 256 threads owns a tile of 256*J output samples of
// one row; thread x owns samples t0 + x + 256*j (j < J), so every global
// read and write of a warp is contiguous whatever the alignment of a
// pulse.  The block first lists the pulses that overlap its tile, in
// pulse order, in shared memory (chunks of up to 256):
//   ragged   two warps search the row's ascending offsets (32 probes per
//            round, O(log P)) for the first pulse that ends after t0 and
//            the first that starts at or after the tile's end; the pulses
//            between them are exactly those that touch the tile.
//   general  each chunk of 256 pulses is tested one pulse per thread and
//            the hits are compacted with warp ballots and a prefix over
//            the 8 warp counts, which keeps pulse order: O(P / 256) work
//            per thread instead of O(P).
// It then adds the listed pulses, each thread summing its samples in list
// order from zero: no atomics, bit-identical to the sequential per-pulse
// scatter-add (the plain versions in world_tpu_torch/ops/ola.py).  The
// loads are data-dependent, so latency, not bandwidth, limits a thread
// that issues one at a time: each thread issues the predicated loads of
// 32/J pulses x J samples into registers before their adds (32 loads in
// flight).  Staging the slices in shared memory with cp.async instead,
// double-buffered, was measured and was slower where inputs are warm in
// L2, as on the main path (PERF.md).  The wrapper picks the tile from fft.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 32;   // loads in flight per thread

// The pulses that overlap a block's tile, up to kThreads at a time, in
// pulse order: offset and row index (into the response rows) of each.
struct PulseList {
  int off[kThreads];
  int row[kThreads];
  int warp_hits[kWarps];
  int range[2];
};

// First p in [a, b) with pred(off[p]), or b; pred must be false then true
// along [a, b).  Called by one whole warp: 32 probes per round.
template <class Pred>
__device__ int first_true(const int* __restrict__ off, int a, int b,
                          Pred pred) {
  const int lane = threadIdx.x & 31;
  while (b - a > 32) {
    const int step = (b - a + 31) >> 5;
    const int p = a + lane * step;
    const bool no = p < b && !pred(__ldg(off + p));
    const int c = __popc(__ballot_sync(0xffffffffu, no));
    if (c == 0) return a;
    // off[a + (c-1)*step] fails; a + c*step passes or lies at/after b.
    b = min(b, a + c * step);
    a += (c - 1) * step + 1;
  }
  const int p = a + lane;
  const bool no = p < b && !pred(__ldg(off + p));
  return a + __popc(__ballot_sync(0xffffffffu, no));
}

// Calls add(n) once for each chunk of n >= 1 listed pulses.
template <int kTile, bool kRagged, class Add>
__device__ void for_each_chunk(PulseList& list, const int* __restrict__ off,
                               const int* __restrict__ row_ptr, int b, int P,
                               int fft, int t0, Add add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kRagged) {
    if (warp < 2) {
      const int rs = __ldg(row_ptr + b), re = __ldg(row_ptr + b + 1);
      const int end = t0 + kTile;
      const int v = warp == 0
          ? first_true(off, rs, re, [=](int o) { return o + fft > t0; })
          : first_true(off, rs, re, [=](int o) { return o >= end; });
      if (lane == 0) list.range[warp] = v;
    }
    __syncthreads();
    const int lo = list.range[0], hi = list.range[1];
    for (int c = lo; c < hi; c += kThreads) {
      const int n = min(kThreads, hi - c);
      if (threadIdx.x < n) {
        list.off[threadIdx.x] = __ldg(off + c + threadIdx.x);
        list.row[threadIdx.x] = c + threadIdx.x;
      }
      __syncthreads();
      add(n);
      __syncthreads();
    }
  } else {
    const int* offb = off + static_cast<size_t>(b) * P;
    for (int c = 0; c < P; c += kThreads) {
      const int p = c + threadIdx.x;
      int o = 0;
      bool hit = false;
      if (p < P) {
        o = __ldg(offb + p);
        hit = o < t0 + kTile && o + fft > t0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) list.warp_hits[warp] = __popc(m);
      __syncthreads();
      int before = 0, n = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int h = list.warp_hits[w];
        before += w < warp ? h : 0;
        n += h;
      }
      if (hit) {
        const int pos = before + __popc(m & ((1u << lane) - 1u));
        list.off[pos] = o;
        list.row[pos] = b * P + p;
      }
      __syncthreads();
      if (n > 0) add(n);
      __syncthreads();
    }
  }
}

// The loads of kUnroll pulses issued before their adds.
template <typename T, int J>
__device__ void add_registers(const PulseList& list, int n,
                              const T* __restrict__ resp, int fft, int s0,
                              T (&acc)[J]) {
  constexpr int kUnroll = kInFlight / J;
  for (int i = 0; i < n; i += kUnroll) {
    T v[kUnroll][J];
    bool ok[kUnroll][J];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool live = i + k < n;
      const int q = live ? i + k : i;
      const int o = list.off[q];
      const T* row = resp + static_cast<size_t>(list.row[q]) * fft;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = s0 + j * kThreads - o;
        ok[k][j] =
            live && static_cast<unsigned>(r) < static_cast<unsigned>(fft);
        v[k][j] = ok[k][j] ? __ldg(row + r) : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (ok[k][j]) acc[j] += v[k][j];
      }
    }
  }
}

template <typename T, int J, bool kRagged>
__global__ void __launch_bounds__(kThreads)
ola_kernel(const T* __restrict__ resp, const int* __restrict__ off,
           const int* __restrict__ row_ptr, T* __restrict__ out, int P,
           int fft, int y_padded) {
  constexpr int kTile = kThreads * J;
  __shared__ PulseList list;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int s0 = t0 + threadIdx.x;
  T acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = T(0);
  for_each_chunk<kTile, kRagged>(
      list, off, row_ptr, b, P, fft, t0,
      [&](int n) { add_registers<T, J>(list, n, resp, fft, s0, acc); });
  T* outb = out + static_cast<size_t>(b) * y_padded;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j * kThreads;
    if (s < y_padded) outb[s] = acc[j];
  }
}

template <typename T, int J>
int launch(const T* resp, const int* off, const int* row_ptr, T* out, int B,
           int P, int fft, int y_padded, cudaStream_t stream) {
  constexpr int kTile = kThreads * J;
  const dim3 grid((y_padded + kTile - 1) / kTile, B);
  if (row_ptr != nullptr) {
    ola_kernel<T, J, true><<<grid, kThreads, 0, stream>>>(
        resp, off, row_ptr, out, P, fft, y_padded);
  } else {
    ola_kernel<T, J, false><<<grid, kThreads, 0, stream>>>(
        resp, off, row_ptr, out, P, fft, y_padded);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(int tile, const void* resp, const void* off,
                const void* row_ptr, void* out, int B, int P, int fft,
                int y_padded, cudaStream_t stream) {
  const T* r = static_cast<const T*>(resp);
  const int* o = static_cast<const int*>(off);
  const int* rp = static_cast<const int*>(row_ptr);
  T* y = static_cast<T*>(out);
  switch (tile) {
    case 2 * kThreads:
      return launch<T, 2>(r, o, rp, y, B, P, fft, y_padded, stream);
    case 4 * kThreads:
      return launch<T, 4>(r, o, rp, y, B, P, fft, y_padded, stream);
    case 8 * kThreads:
      return launch<T, 8>(r, o, rp, y, B, P, fft, y_padded, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One entry for both modes and dtypes.  elt_bytes: 4 (float) or 8
// (double).  row_ptr == NULL selects the general mode, with responses
// (B, P, fft); otherwise the ragged mode, with responses (N, fft) and P
// unused.  tile: 512, 1024 or 2048 output samples per block.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unknown
// configuration).
extern "C" int ola_launch(int elt_bytes, int tile, const void* resp,
                          const void* off, const void* row_ptr, void* out,
                          int B, int P, int fft, int y_padded, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 4) {
    return launch_tile<float>(tile, resp, off, row_ptr, out, B, P, fft,
                              y_padded, s);
  }
  if (elt_bytes == 8) {
    return launch_tile<double>(tile, resp, off, row_ptr, out, B, P, fft,
                               y_padded, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
