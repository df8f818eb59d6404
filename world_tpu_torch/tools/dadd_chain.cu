// Latency of one dependent double add on the card: one thread adds
// ``step`` to an accumulator ``n`` times, each add waiting for the last,
// as csrc/scan.cu's thread 0 does once per sample.  The host times two
// chain lengths with CUDA events; their difference over the extra adds
// is the latency, launch overhead cancelled (tools/scan_bench.py:
// dadd_latency_ns).  Built with nvcc at first use into _build/.

#include <cuda_runtime.h>

__global__ void dadd_chain_kernel(double* out, long long n, double step) {
  double acc = 0.0;
#pragma unroll 16
  for (long long i = 0; i < n; ++i) acc += step;
  *out = acc;
}

// One block of one thread.  Returns the cudaError_t of the launch.
extern "C" int dadd_chain_launch(void* out, long long n, double step,
                                 void* stream) {
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), n, step);
  return static_cast<int>(cudaGetLastError());
}
