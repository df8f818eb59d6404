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
// Bound: operations (a jump is 128 rows of four ANDs, three XORs and a
// popc a set bit; a draw 12 steps of about eight integer operations),
// and within a lane the chain of its draws: each xorshift step waits on
// the last through w (a shift and two XORs, 7.1 ns on the H100;
// tools/iir_chain.cu measures it).  Bytes (8 per draw written) are far
// below.  The integer pipe issues a warp instruction in two cycles
// whatever its active threads, so a thread working alone in a warp costs
// as much as 32.
//
// Design.  One block of kWarps warps an SM, persistent, its warps
// numbered block-fastest so that few lanes still spread over every SM.
// Each block first stages in shared memory (cp.async) the jump rows the
// span needs (n_bits x 128 rows of 16 bytes: the matrices packed into 4
// words of 32 bits) and the rows of the draw split below.  A warp takes
// per_warp lanes at a time: one while the lanes fit the card's warps at
// once (4,224 on the H100), else as few as fit them in one round, up to
// 32 / kDrawers.  For each of its lanes, in turn (the warp's starts come
// in one load, a shuffle hands each out):
//   - A jump is four ballots: for word w of the new state, thread j takes
//     the parity of popc(row[w*32 + j] & state) over the four words, and
//     __ballot_sync gathers the 32 parities, bit j in place.  Thread j
//     reads row w*32 + j: 16 bytes a thread on consecutive addresses,
//     conflict-free.  Every thread holds the whole state, so a set bit of
//     the start (only the set bits are walked) costs the warp four such
//     steps where one thread took 128.
//   - The lane's 64 draws are split among kDrawers threads: share t
//     starts at draw t * 64 / kDrawers, from M^(t * 64 / kDrawers) times
//     the lane's state, made by the same ballots from the split table
//     (kDrawers - 1 matrices).
// Then thread g * kDrawers + t draws share t of the warp's lane g: a
// chain of 12 * 64 / kDrawers steps where one thread walked 768, with up
// to all 32 threads drawing at once, each writing its draws contiguously
// (16-byte stores).  768 steps of 7.17 ns (the step's latency on the
// H100, tools/iir_chain.cu) alone take 5.5 us, where the whole launch at
// 2,559 lanes takes 8.4 us split (world_tpu_torch/tools/iir_bench.py).
// Everything but the last subtraction is integer arithmetic and the
// scale is a power of two, so the kernel equals the plain version
// exactly.  Shared memory: (n_bits + kDrawers - 1) x 2 KB, at most 82 KB
// (dynamic; the entry raises the kernel's limit to that once a device).

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;      // warps a block (one block an SM)
constexpr int kThreads = 32 * kWarps;
constexpr int kLane = 64;       // draws per lane (ops/rng.py: _LANE)
constexpr int kRows = 128;      // rows of one jump matrix
constexpr int kMaxBits = 34;    // ops/rng.py: _MAX_LOG2
constexpr int kDrawers = 8;     // threads drawing a lane (rng.py: _DRAWERS)
constexpr int kMaxSmem = (kMaxBits + kDrawers - 1) * kRows * 16;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;

struct State {
  unsigned x, y, z, w;
};

__device__ __forceinline__ unsigned parity(uint4 r, State s) {
  return static_cast<unsigned>(
             __popc((r.x & s.x) ^ (r.y & s.y) ^ (r.z & s.z) ^ (r.w & s.w)))
         & 1u;
}

// M s, M's packed rows at m (shared memory), thread j of the warp making
// bit j of each word.  Every thread of the warp must call it.
__device__ __forceinline__ State jump(const uint4* m, int j, State s) {
  State t;
  t.x = __ballot_sync(kFullMask, parity(m[j], s));
  t.y = __ballot_sync(kFullMask, parity(m[32 + j], s));
  t.z = __ballot_sync(kFullMask, parity(m[64 + j], s));
  t.w = __ballot_sync(kFullMask, parity(m[96 + j], s));
  return t;
}

// One normal: 12 xorshift128 steps from s, acc * 2^-28 - 6.
__device__ __forceinline__ double draw(State& s) {
  unsigned acc = 0u;            // 12 values below 2^28: below 2^32
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const unsigned t = s.x ^ (s.x << 11);
    s.x = s.y;
    s.y = s.z;
    s.z = s.w;
    s.w = (s.w ^ (s.w >> 19)) ^ (t ^ (t >> 8));
    acc += s.w >> 4;
  }
  return __dadd_rn(__dmul_rn(static_cast<double>(acc), 0x1p-28), -6.0);
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

// per_warp lanes a warp at a time (1 <= per_warp <= 32 / kDrawers): their
// jumps one after another, then thread g * kDrawers + t draws lane g's
// share t.  Starts are read below 2^n_bits, as the plain version does.
__global__ void __launch_bounds__(kThreads)
randn_span_kernel(const long long* __restrict__ starts,
                  const uint4* __restrict__ rows, int n_bits,
                  const uint4* __restrict__ split, State seed,
                  double* __restrict__ out, int lanes, int per_warp) {
  constexpr int kDraws = kLane / kDrawers;
  extern __shared__ uint4 rows_s[];     // n_bits jump matrices, the split
  uint4* split_s = rows_s + n_bits * kRows;
  for (int i = threadIdx.x; i < n_bits * kRows; i += kThreads) {
    copy_async16(rows_s + i, rows + i);
  }
  for (int i = threadIdx.x; i < (kDrawers - 1) * kRows; i += kThreads) {
    copy_async16(split_s + i, split + i);
  }
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int j = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int g = j / kDrawers, t = j % kDrawers;   // this thread's draws
  // Whole warps walk the lanes (the ballots need all 32 threads), the
  // blocks' warps numbered block-fastest, so few lanes still spread
  // over every SM.
  for (int base = (warp * static_cast<int>(gridDim.x) + blockIdx.x)
                  * per_warp;
       base < lanes; base += gridDim.x * kWarps * per_warp) {
    // The warp's starts in one load, thread k holding lane base + k's.
    const long long start = j < per_warp && base + j < lanes
                                ? starts[base + j] : 0;
    State mine = seed;
    for (int k = 0; k < per_warp && base + k < lanes; ++k) {
      // Bits from n_bits up are not read, as in the plain version.
      unsigned long long bits = static_cast<unsigned long long>(
          __shfl_sync(kFullMask, start, k)) & ((1ull << n_bits) - 1ull);
      State s = seed;
      for (; bits; bits &= bits - 1) {  // the start's set bits, upward
        s = jump(rows_s + (__ffsll(static_cast<long long>(bits)) - 1) * kRows,
                 j, s);
      }
      if (j == k * kDrawers) mine = s;  // share 0: the lane's own state
#pragma unroll
      for (int u = 1; u < kDrawers; ++u) {
        const State su = jump(split_s + (u - 1) * kRows, j, s);
        if (j == k * kDrawers + u) mine = su;
      }
    }
    if (g < per_warp && base + g < lanes) {
      double2* o = reinterpret_cast<double2*>(
          out + static_cast<long long>(base + g) * kLane + t * kDraws);
#pragma unroll 4
      for (int d = 0; d < kDraws / 2; ++d) {
        const double a = draw(mine);
        o[d] = make_double2(a, draw(mine));
      }
    }
  }
}

// The device's SM count, after raising the kernel's dynamic shared memory
// limit to kMaxSmem there: both once a device, cached (0 until then).
std::atomic<int> sms_of[kMaxDevices];

cudaError_t prepare(int dev, int* sms) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sms_of[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      randn_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) sms_of[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

int launch(const long long* starts, const uint4* rows, int n_bits,
           const uint4* split, State seed, double* out, int lanes,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (n_bits + kDrawers - 1) * kRows
                   * static_cast<int>(sizeof(uint4));
  // A block an SM.  One lane a warp while the lanes fit the card's warps
  // at once; past that, as few lanes a warp as fit them in one round, up
  // to 32 / kDrawers.  (Packing more, so the draws fill a warp's threads,
  // measured slower: a warp's lanes jump one after another.)
  int per_warp = (lanes + sms * kWarps - 1) / (sms * kWarps);
  if (per_warp > 32 / kDrawers) per_warp = 32 / kDrawers;
  const int warps = (lanes + per_warp - 1) / per_warp;
  randn_span_kernel<<<warps < sms ? warps : sms, kThreads, smem, stream>>>(
      starts, rows, n_bits, split, seed, out, lanes, per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// starts: (lanes,) int64 stream positions, each below 2^n_bits; rows: the
// (34, 128, 4) packed jump rows (n_bits <= 34); split: the (kDrawers - 1,
// 128, 4) packed rows of M^(t * 64 / kDrawers), t = 1 .. kDrawers - 1
// (ops/rng.py: _split_rows); seed: the four state words; out: (lanes, 64)
// float64, 16-byte aligned.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for n_bits out of range).
extern "C" int randn_span_launch(const void* starts, const void* rows,
                                 int n_bits, const void* split, unsigned s0,
                                 unsigned s1, unsigned s2, unsigned s3,
                                 void* out, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  if (n_bits < 0 || n_bits > kMaxBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(static_cast<const long long*>(starts),
                static_cast<const uint4*>(rows), n_bits,
                static_cast<const uint4*>(split), State{s0, s1, s2, s3},
                static_cast<double*>(out), lanes,
                static_cast<cudaStream_t>(stream));
}
