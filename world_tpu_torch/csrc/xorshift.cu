// The reference RNG over a span of its stream, CUDA C++ for sm_90a.
//
// The reference draws normals from one xorshift128 stream, each the sum of
// 12 draws of (w >> 4) scaled by 2^-28 less 6 (src/matlabfunctions.cpp:
// 237-264), and consumes the stream in data-dependent blocks.  Exact mode
// generates the span [lo, hi + n) of the stream once, in lanes of 64 draws
// (world_tpu_torch/ops/rng.py: randn_blocks_at), each lane starting from a
// jump: the state update is linear over GF(2), so the state after k draws
// is M^k times the seed, M^k the product of the matrices M^(2^b) of k's
// set bits.  This kernel replaces the JAX package's lax.fori_loop over
// those bits (world_tpu/ops/rng.py:82-102) and its lax.scan of draws
// (:112-130), which the port's plain version runs as Python loops over
// the bits and over 64 x 12 steps (states_at_draws, randn_block).
//
// Per lane, one thread: for each set bit b of the lane's start, the state
// becomes M_b . state, output bit i the parity of popc(row_i & state) over
// the four words (the rows are _jump_matrices() packed into 4 words of 32
// bits, 34 x 128 x 4); then 64 draws of 12 xorshift128 steps, each draw
// acc * 2^-28 - 6.0 in float64.  Everything but that last subtraction is
// integer arithmetic and the scale is a power of two, so the kernel equals
// the plain version exactly.
//
// Bound: operations.  A jump is 128 rows of four ANDs, three XORs and a
// popc; a draw 12 steps of about eight integer operations.  Bytes (8 per
// draw written) are far below.  At CheapTrick's span (a few thousand
// lanes) the launch sets the floor.
//
// Design.  The rows are read from device memory: every thread of a warp
// reads the same row at once (one broadcast transaction, cached in L1).
// The state and the packed output bits stay in registers (both loops over
// a jump's rows are unrolled, so every index is a constant).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLane = 64;       // draws per lane (ops/rng.py: _LANE)
constexpr int kWords = 4;       // 32-bit words of the 128-bit state

__global__ void __launch_bounds__(kThreads)
randn_span_kernel(const long long* __restrict__ starts,
                  const uint4* __restrict__ rows, int n_bits, uint4 seed,
                  double* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const unsigned long long offset =
      static_cast<unsigned long long>(starts[lane]);
  unsigned x = seed.x, y = seed.y, z = seed.z, w = seed.w;
  for (int b = 0; b < n_bits; ++b) {
    if (!((offset >> b) & 1ull)) continue;
    const uint4* m = rows + static_cast<long long>(b) * 128;
    unsigned next[kWords];
#pragma unroll
    for (int word = 0; word < kWords; ++word) {
      unsigned bits = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint4 r = m[word * 32 + j];
        const unsigned v = (r.x & x) ^ (r.y & y) ^ (r.z & z) ^ (r.w & w);
        bits |= (static_cast<unsigned>(__popc(v)) & 1u) << j;
      }
      next[word] = bits;
    }
    x = next[0];
    y = next[1];
    z = next[2];
    w = next[3];
  }
  double* o = out + static_cast<long long>(lane) * kLane;
  for (int d = 0; d < kLane; ++d) {
    unsigned acc = 0u;          // 12 values below 2^28: below 2^32
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const unsigned t = x ^ (x << 11);
      x = y;
      y = z;
      z = w;
      w = (w ^ (w >> 19)) ^ (t ^ (t >> 8));
      acc += w >> 4;
    }
    o[d] = __dadd_rn(__dmul_rn(static_cast<double>(acc), 0x1p-28), -6.0);
  }
}

}  // namespace

// starts: (lanes,) int64 stream positions, each below 2^n_bits; rows: the
// (34, 128, 4) packed jump rows (n_bits <= 34); seed: the four state words;
// out: (lanes, 64) float64.  Returns the cudaError_t of the launch.
extern "C" int randn_span_launch(const void* starts, const void* rows,
                                 int n_bits, unsigned s0, unsigned s1,
                                 unsigned s2, unsigned s3, void* out,
                                 int lanes, void* stream) {
  if (lanes <= 0) return 0;
  if (n_bits < 0 || n_bits > 34) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  randn_span_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(starts), static_cast<const uint4*>(rows),
      n_bits, make_uint4(s0, s1, s2, s3), static_cast<double*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
