// Latency of one dependent IEEE divide on the card: one thread divides a
// constant by its last quotient ``n`` times, each divide waiting for the
// last, as the contour walks' thread or warp does once per step
// (csrc/dio_fix.cu, csrc/harvest_contour.cu).  The host times two chain
// lengths with CUDA events; their difference over the extra divides is
// the latency, launch overhead cancelled (tools/contour_bench.py:
// div_latency_ns).  Built with nvcc at first use into _build/, with the
// kernels' flags (IEEE division, as theirs).

#include <cuda_runtime.h>

template <typename T>
__global__ void div_chain_kernel(T* out, long long n, T num) {
  T x = T(1.5);
#pragma unroll 16
  for (long long i = 0; i < n; ++i) x = num / x;
  *out = x;
}

// One block of one thread, float (elt_bytes 4) or double (8).  Returns the
// cudaError_t of the launch.
extern "C" int div_chain_launch(int elt_bytes, void* out, long long n,
                                double num, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 4) {
    div_chain_kernel<float><<<1, 1, 0, s>>>(static_cast<float*>(out), n,
                                            static_cast<float>(num));
  } else if (elt_bytes == 8) {
    div_chain_kernel<double><<<1, 1, 0, s>>>(static_cast<double*>(out), n,
                                             num);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
