// Pitch-synchronous overlap-add for batch synthesis, CUDA C++ for sm_90a.
//
// Replaces world_tpu/ops/pallas_ola.py::_ola_kernel (the TPU kernel keeps
// a VMEM accumulator and adds each pulse with two vector rotates and one
// aligned read-modify-write).  Semantics, not the Mosaic shape: per batch
// row, a y_padded-sample output starts at zero and receives every pulse's
// fft-sample response at that pulse's offset, in pulse order.  Callers
// guarantee 0 <= offset <= y_padded - fft; invalid pulses carry all-zero
// responses.  Offsets need not be sorted.
//
// Bound: bytes.  Each response sample is read once and each output sample
// written once (16 x 1249 x 1024 float32 responses at 22.05 kHz are 82 MB,
// about 25 us at 3.35 TB/s); the arithmetic is one add per response sample.
//
// Design: one thread per output sample, a block per (256-sample tile,
// batch row).  Each block walks the row's pulses in order, staging their
// offsets through shared memory, skips pulses that miss its tile (a
// block-uniform branch) and otherwise adds resp[b, p, s - off] from a
// zero start.  Every output sample is therefore summed in pulse order with
// no atomics, bit-identical to the sequential scatter-add (the plain
// version in world_tpu_torch/ops/ola.py).  Reads of one pulse by one block
// are 256 contiguous samples.  The O(P) offset walk per block is the cost
// a later binary search over sorted offsets would remove.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;

template <typename T>
__global__ void __launch_bounds__(kTile)
ola_kernel(const T* __restrict__ resp, const int* __restrict__ off,
           T* __restrict__ out, int P, int fft, int y_padded) {
  __shared__ int s_off[kTile];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int s = t0 + threadIdx.x;
  const int* offb = off + static_cast<size_t>(b) * P;
  const T* rb = resp + static_cast<size_t>(b) * P * fft;
  T acc = T(0);
  for (int p0 = 0; p0 < P; p0 += kTile) {
    const int n = min(kTile, P - p0);
    __syncthreads();
    if (threadIdx.x < n) s_off[threadIdx.x] = offb[p0 + threadIdx.x];
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const int o = s_off[q];
      if (o >= t0 + kTile || o + fft <= t0) continue;  // misses the tile
      const int r = s - o;
      if (r >= 0 && r < fft) {
        acc += rb[static_cast<size_t>(p0 + q) * fft + r];
      }
    }
  }
  if (s < y_padded) out[static_cast<size_t>(b) * y_padded + s] = acc;
}

template <typename T>
int launch(const T* resp, const int* off, T* out, int B, int P, int fft,
           int y_padded, cudaStream_t stream) {
  dim3 grid((y_padded + kTile - 1) / kTile, B);
  ola_kernel<T><<<grid, kTile, 0, stream>>>(resp, off, out, P, fft,
                                            y_padded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ola_accumulate_f32(const void* resp, const void* off,
                                  void* out, int B, int P, int fft,
                                  int y_padded, void* stream) {
  return launch(static_cast<const float*>(resp), static_cast<const int*>(off),
                static_cast<float*>(out), B, P, fft, y_padded,
                static_cast<cudaStream_t>(stream));
}

extern "C" int ola_accumulate_f64(const void* resp, const void* off,
                                  void* out, int B, int P, int fft,
                                  int y_padded, void* stream) {
  return launch(static_cast<const double*>(resp),
                static_cast<const int*>(off), static_cast<double*>(out), B, P,
                fft, y_padded, static_cast<cudaStream_t>(stream));
}
