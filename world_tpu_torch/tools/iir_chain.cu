// Latency of one step of the IIR recurrences' dependent chain on the card:
// one thread runs n steps of acc = (((acc * c) + d) + d ...), one multiply
// then ``adds`` adds, each waiting for the last, with the rounding
// intrinsics of csrc/iir.cu (built with -fmad=false, so nothing fuses).
// That is the critical path of one sample of decimate's stage (a multiply
// and three adds through w0), of the smoothing biquad (a multiply and two
// adds through y1) and of one block of the state scan (a multiply and S
// adds), in float64 or float32.  The host times two chain lengths with
// CUDA events; their difference over the extra steps is the latency,
// launch overhead cancelled (tools/iir_bench.py: step_latency_ns).  Built
// with nvcc at first use into _build/.

#include <cuda_runtime.h>

namespace {

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

template <typename T, int kAdds>
__global__ void iir_chain_kernel(T* out, long long n, T c, T d) {
  T acc = d;
#pragma unroll 8
  for (long long i = 0; i < n; ++i) {
    T v = mul_rn(acc, c);
#pragma unroll
    for (int a = 0; a < kAdds; ++a) v = add_rn(v, d);
    acc = v;
  }
  *out = acc;
}

__global__ void xorshift_chain_kernel(unsigned* out, long long n,
                                      uint4 s) {
  unsigned x = s.x, y = s.y, z = s.z, w = s.w, acc = 0u;
#pragma unroll 12
  for (long long i = 0; i < n; ++i) {
    const unsigned t = x ^ (x << 11);
    x = y;
    y = z;
    z = w;
    w = (w ^ (w >> 19)) ^ (t ^ (t >> 8));
    acc += w >> 4;
  }
  out[0] = w;
  out[1] = acc;
}

template <typename T>
int launch(int adds, void* out, long long n, double c, double d,
           cudaStream_t s) {
  T* o = static_cast<T*>(out);
  switch (adds) {
    case 2: iir_chain_kernel<T, 2><<<1, 1, 0, s>>>(o, n, T(c), T(d)); break;
    case 3: iir_chain_kernel<T, 3><<<1, 1, 0, s>>>(o, n, T(c), T(d)); break;
    case 4: iir_chain_kernel<T, 4><<<1, 1, 0, s>>>(o, n, T(c), T(d)); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block of one thread; out is one float (elt_bytes 4) or double (8);
// adds is 2, 3 or 4.  Returns the cudaError_t of the launch.
extern "C" int iir_chain_launch(int elt_bytes, int adds, void* out,
                                long long n, double c, double d,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 4) return launch<float>(adds, out, n, c, d, s);
  if (elt_bytes == 8) return launch<double>(adds, out, n, c, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One block of one thread, n xorshift128 steps from the reference's seed;
// out: two 32-bit words (the last w and the sum of w >> 4).  Returns the
// cudaError_t of the launch.
extern "C" int xorshift_chain_launch(void* out, long long n, void* stream) {
  xorshift_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), n,
      make_uint4(123456789u, 362436069u, 521288629u, 88675123u));
  return static_cast<int>(cudaGetLastError());
}
