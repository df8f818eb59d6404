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
//   27-125):  wt = ((x + a0*w0) + a1*w1) + a2*w2,
//             y  = ((b0*wt + b1*w0) + b1*w1) + b0*w2;
//   the smoothing biquad, direct form I (src/harvest.cpp:1058-1085):
//             y  = (((b0*x + b1*x1) + b0*x2) + a0*y1) + a1*y2.
// Every product and sum rounds on its own (the _rn intrinsics, and the
// source is built with -fmad=false), left to right as the plain
// version's separate tensor ops, so the kernel equals it bit for bit.
//
// lti_state_scan replaces the lax.scan of lti_block_filter
// (world_tpu/ops/matlab.py:167-187), a Python loop over 128-sample blocks
// in the port: states[j] = s, then s = AL s + p[j], from s = 0.  Row i of
// AL s + p[j] is ((s0*AL[i,0] + s1*AL[i,1]) + ...) + p[j,i], the order of
// the plain version (world_tpu_torch/ops/iir.py: lti_state_scan_plain).
// Its chain thread and helpers split the work as the zero-phase kernel's
// do (the state-scan design, below).
//
// Bound: the chain.  A lane is one dependent sequence: per sample, through
// w0, a multiply and three adds (decimate: 16.35 ns on the H100), through
// y1 a multiply and two adds (the biquad: 12.28 ns); per block of the
// state scan a multiply and S adds.  No order-keeping version beats
// length x 2 passes x that latency (tools/iir_chain.cu measures it);
// bytes and operations are far below.  A lane cannot be split without
// reassociating, so the aim is to issue nothing but the chain on the
// chain's thread.
//
// Zero-phase design.  A block of kZpThreads walks one lane: thread 0
// walks the lane's chain, and only that (decimate: the multiply and three
// adds through w0, plus the two products a1*w1 and a2*w2 of the next
// step, which wait on nothing; the biquad: a multiply and two adds
// through y1, plus a1*y1 for the next step).  Warps 1-3, the helpers, do
// everything else, kChunk samples at a time, through shared memory:
//   - copy the inputs two chunks ahead into a ring of three raw buffers
//     (cp.async, 8 bytes an element, consecutive threads on consecutive
//     samples; zeros past the row's end);
//   - the biquad: u = (b0*x + b1*x1) + b0*x2, the left-to-right prefix of
//     its sum, for the next chunk, from the raw ring (x1 and x2 of a
//     chunk's first samples are the previous chunk's last);
//   - decimate: y = ((b0*wt + b1*w0) + b1*w1) + b0*w2 of the last chunk
//     from the chain's wt values (each chunk's buffer starts with the
//     three wt values before it, which the chain thread writes there);
//   - write the last chunk's outputs, coalesced.
// The chain thread reads its inputs from shared memory kGroup at a time
// into registers, the next group's while the current one steps (two
// register groups in turn), and waits only at a chunk's end (one
// __syncthreads a chunk).  The backward pass reads the forward pass's
// output (in L2) from the end, in reverse chunks, and writes in place:
// in a chunk's phase the helpers read two chunks ahead and write one
// behind, so no index is read after it is written.  Rows of any length
// work: only the chunks live in shared memory.
// Lanes to blocks: one lane a block at every lane count.  The float64
// inputs the port runs have 1 lane (analyze()'s decimation and
// smoothing) or 16 (the float64 batch step's), so each chain has an SM,
// and its warp a scheduler, to itself (warp w issues on sub-partition
// w % 4; the helpers are warps 1-3).  More lanes stay correct: the
// blocks queue on the SMs.
// Shared memory: 28.7 KB a block; 168 registers, no spills.  On the H100
// (NVIDIA H100 80GB HBM3, 700 W) a sample takes ~20 ns of decimate's
// 16.35 ns chain (world_tpu_torch/tools/iir_bench.py).
//
// State-scan design.  The same 128 threads: thread t < L of warp 0 walks
// lane t of the block's L lanes, and only that: per block of the row, S
// rows of S products and S adds, reading the block's p as one vector
// (a Quad, S values padded to four) and writing the pre-block state as
// one.  The chain keeps AL and s in registers and reads p from shared
// memory kScanGroup blocks at a time, the next group's while the current
// one steps (two register groups in turn, as run_chain).  Warps 1-3, the
// helpers, copy each lane's p two chunks ahead into a ring of three
// chunk buffers (cp.async, consecutive threads on consecutive elements
// of the lane's contiguous row: coalesced) and write the last chunk's
// states from a ring of two, coalesced the same way; one __syncthreads a
// chunk.  A chunk buffer is kScanChunkBytes: 512 float32 or 256 float64
// Quads, `steps` blocks of each lane (rounded down to pairs of register
// groups), lane l's at Quads l*pitch onwards.  So a chain thread reads
// and writes consecutive Quads at offsets fixed at compile time (a lane
// stride known only at run time, blocks interleaved lane by lane, took
// 16-29% longer on the recorded 3-state rows on the H100, NVIDIA H100
// 80GB HBM3 at 700 W, world_tpu_torch/tools/iir_bench.py); with several
// lanes a block, pitch = steps + 1 staggers the lanes' Quads over the
// shared-memory banks.  Rows of any length run through the ring.
// Lanes to blocks: L = ceil(lanes / SMs), at most 16.  While the lanes
// fit on the SMs (every recorded input: the float32 decimation's and
// smoothing's 16 lanes) each lane has a block, its chain an SM and a
// scheduler to itself; more lanes (a batch of more rows than SMs) share
// a block's chain warp, whose threads step in lock step, so a launch is
// one wave of blocks until lanes exceed 16 x SMs.  On the H100 that
// layout took 0.0045 ms at 1,616 lanes of 14 blocks against one lane a
// block's 0.0053, and 0.0078 at 200 lanes of 300 against its 0.0074.
// The chain thread executes S*S multiplies, S*S adds and two vector
// accesses a block, not only the S + 1 dependent operations of the
// chain: the kernel takes ~19.1 ns a block on long rows (16 x 2,682
// blocks in 0.0513 ms) against the chain's 8.53; what holds the rest is
// not measured.
// Shared memory: 40,960 bytes a block (5 chunk buffers); 52-87 registers
// in float32 and 76-124 in float64, no spills.

#include <cuda_runtime.h>

#include <atomic>

namespace {

// The zero-phase kernel's shape.
constexpr int kZpThreads = 128;   // thread 0: the chain; warps 1-3: helpers
constexpr int kHelpers = kZpThreads - 32;
constexpr int kChunk = 512;     // samples a chunk
constexpr int kPad = 4;         // slots before a chunk's chain outputs
constexpr int kGroup = 32;      // inputs the chain reads ahead
// Samples of a chunk each helper handles (kChunk over kHelpers).
constexpr int kPerHelper = (kChunk + kHelpers - 1) / kHelpers;
// Shared memory, in doubles: the raw ring (3 chunks), u (2) and the
// chain's outputs (2, history slots in front).
constexpr int kOut = kPad + kChunk;
constexpr int kZpDoubles = 3 * kChunk + 2 * kChunk + 2 * kOut;
static_assert(kChunk % (2 * kGroup) == 0, "chunk shape");

// The state scan's shape (the same 128 threads: warp 0's first lanes walk
// the chains, warps 1-3 are the helpers).
constexpr int kScanChunkBytes = 8192;  // a chunk buffer
constexpr int kScanGroup = 4;          // blocks the chain reads ahead
constexpr int kScanMaxLanes = 16;      // lanes a block at most (warp 0's)
constexpr int kScanIn = 3;             // input ring: chunks
constexpr int kScanOut = 2;            // output ring: chunks

// A block's input or state, S <= 4 values padded to one 16-byte (float)
// or 32-byte (double) vector access.
template <typename T>
struct __align__(4 * sizeof(T)) Quad {
  T v[4];
};
template <typename T>
constexpr int kScanQuads = kScanChunkBytes / static_cast<int>(sizeof(Quad<T>));
static_assert(kScanQuads<double> / kScanMaxLanes - 1 >= 2 * kScanGroup,
              "a chunk holds a pair of register groups of every lane");

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

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for all but the most recent group of this thread's copies.
__device__ __forceinline__ void wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Barrier of the helper warps alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kHelpers) : "memory");
}

// c = (a0, a1, a2, b0, b1) of _DECIMATE_COEFFS[r].  The chain reads the
// raw inputs; the helpers turn its wt values into outputs.
struct Decimate {
  static constexpr bool kPrep = false;
  double a0, a1, a2, b0, b1;
  double w0, w1, w2, q1, q2;    // q1 = a1*w1, q2 = a2*w2
  __device__ Decimate(double c0, double c1, double c2, double c3, double c4)
      : a0(c0), a1(c1), a2(c2), b0(c3), b1(c4) {
    reset();
  }
  __device__ void reset() {
    w0 = w1 = w2 = 0.0;
    q1 = mul_rn(a1, w1);
    q2 = mul_rn(a2, w2);
  }
  __device__ __forceinline__ double step(double xi) {
    const double wt = add_rn(add_rn(add_rn(xi, mul_rn(a0, w0)), q1), q2);
    q2 = mul_rn(a2, w1);          // the next step's a2*w2 and a1*w1
    q1 = mul_rn(a1, w0);
    w2 = w1;
    w1 = w0;
    w0 = wt;
    return wt;
  }
  // The wt values before a chunk, into its buffer's last pad slots.
  __device__ __forceinline__ void history(double* out) const {
    out[kPad - 3] = w2;
    out[kPad - 2] = w1;
    out[kPad - 1] = w0;
  }
  __device__ __forceinline__ double prep(double, double, double) const {
    return 0.0;                 // unused: the chain reads the raw inputs
  }
  // Output of the sample whose wt sits at p (its predecessors before).
  __device__ __forceinline__ double output(const double* p) const {
    return add_rn(add_rn(add_rn(mul_rn(b0, p[0]), mul_rn(b1, p[-1])),
                         mul_rn(b1, p[-2])),
                  mul_rn(b0, p[-3]));
  }
};

// c = (b0, b1, a0, a1, unused) of the smoothing biquad.  The helpers give
// the chain u = (b0*x + b1*x1) + b0*x2; the chain's y is the output.
struct Biquad {
  static constexpr bool kPrep = true;
  double b0, b1, a0, a1;
  double y1, y2, q;             // q = a1*y2
  __device__ Biquad(double c0, double c1, double c2, double c3, double)
      : b0(c0), b1(c1), a0(c2), a1(c3) {
    reset();
  }
  __device__ void reset() {
    y1 = y2 = 0.0;
    q = mul_rn(a1, y2);
  }
  __device__ __forceinline__ double step(double u) {
    const double y = add_rn(add_rn(u, mul_rn(a0, y1)), q);
    q = mul_rn(a1, y1);           // the next step's a1*y2
    y2 = y1;
    y1 = y;
    return y;
  }
  __device__ __forceinline__ void history(double*) const {}
  __device__ __forceinline__ double prep(double x, double x1,
                                         double x2) const {
    return add_rn(add_rn(mul_rn(b0, x), mul_rn(b1, x1)), mul_rn(b0, x2));
  }
  __device__ __forceinline__ double output(const double* p) const {
    return p[0];
  }
};

// The chain over m samples: inputs at in[k], outputs to out[k].  Two
// groups of kGroup inputs in registers, in turn: one steps while the next
// is read (no copies between them).  A group past m steps on slots whose
// results nobody reads (the chunk's buffers hold kChunk samples, a
// multiple of 2 * kGroup).
__device__ __forceinline__ void read_group(double (&v)[kGroup],
                                           const double* in) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) v[k] = in[k];
}

template <class F>
__device__ __forceinline__ void step_group(F& f, const double (&v)[kGroup],
                                           double* out) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) out[k] = f.step(v[k]);
}

template <class F>
__device__ __forceinline__ void run_chain(F& f, const double* in,
                                          double* out, int m) {
  double a[kGroup], b[kGroup];
  read_group(a, in);
  for (int g = 0; g < m; g += 2 * kGroup) {
    if (g + kGroup < m) read_group(b, in + g + kGroup);
    step_group(f, a, out + g);
    if (g + kGroup >= m) break;
    if (g + 2 * kGroup < m) read_group(a, in + g + 2 * kGroup);
    step_group(f, b, out + g + kGroup);
  }
}

// One pass of f over the block's lane: row[at(0)], row[at(1)], ... of src
// to dst[at(k)], at(k) = k (forward) or n - 1 - k (backward).  src and
// dst may be the same row (see the design note).  Phase c (between two
// __syncthreads): the chain walks chunk c; the helpers write chunk c-1,
// start copying chunk c+2, wait for chunk c+1 and (the biquad) compute
// its u.
template <class F, bool kBackward>
__device__ void zero_phase_pass(F& f, const double* src, double* dst,
                                long long n, double* smem) {
  constexpr int C = kChunk;
  double* raw = smem;                   // 3 chunks: chunk c in c % 3
  double* in = raw + 3 * C;             // 2 chunks: u of chunk c in c % 2
  double* out = in + 2 * C;             // 2 x kOut: chain out, c % 2
  const long long chunks = (n + C - 1) / C;
  const int tid = static_cast<int>(threadIdx.x);
  const int h = tid - 32;               // helper index (warps 1-3)

  auto at = [&](long long c, int k) {
    const long long pos = c * C + k;
    return kBackward ? n - 1 - pos : pos;
  };
  auto load = [&](long long c) {        // chunk c into raw[c % 3]
    double* r = raw + (c % 3) * C;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      const int k = h + i * kHelpers;
      if (k >= C) break;
      if (c * C + k < n) {
        copy_async(r + k, src + at(c, k));
      } else {
        r[k] = 0.0;
      }
    }
    commit_copies();
  };
  auto prep = [&](long long c) {        // chunk c's u into in[c % 2]
    const double* r = raw + (c % 3) * C;
    const double* p = raw + ((c + 2) % 3) * C;   // chunk c - 1
    double* u = in + (c % 2) * C;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      const int k = h + i * kHelpers;
      if (k >= C) break;
      const double x1 = k >= 1 ? r[k - 1] : (c > 0 ? p[C - 1] : 0.0);
      const double x2 = k >= 2 ? r[k - 2] : (c > 0 ? p[C - 2 + k] : 0.0);
      u[k] = f.prep(r[k], x1, x2);
    }
  };
  auto emit = [&](long long c) {        // chunk c's outputs to dst
    const double* o = out + (c % 2) * kOut + kPad;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      const int k = h + i * kHelpers;
      if (k >= C) break;
      if (c * C + k < n) dst[at(c, k)] = f.output(o + k);
    }
  };

  f.reset();
  if (h >= 0) {
    load(0);
    if (chunks > 1) load(1); else commit_copies();
    wait_all_but_last();
    if (F::kPrep) {
      helpers_sync();
      prep(0);
    }
  }
  __syncthreads();
  for (long long c = 0; c < chunks; ++c) {
    if (tid == 0) {
      const int m = static_cast<int>(c * C + C <= n ? C : n - c * C);
      double* o = out + (c % 2) * kOut;
      f.history(o);
      run_chain(f, F::kPrep ? in + (c % 2) * C : raw + (c % 3) * C,
                o + kPad, m);
    } else if (h >= 0) {
      if (c > 0) emit(c - 1);
      if (c + 2 < chunks) load(c + 2); else commit_copies();
      wait_all_but_last();              // chunk c + 1 has landed
      if (F::kPrep && c + 1 < chunks) {
        helpers_sync();
        prep(c + 1);
      }
    }
    __syncthreads();
  }
  if (h >= 0) emit(chunks - 1);
  __syncthreads();
}

template <class F>
__global__ void __launch_bounds__(kZpThreads)
zero_phase_kernel(const double* x, double* y, long long n, double c0,
                  double c1, double c2, double c3, double c4) {
  __shared__ double smem[kZpDoubles];
  const long long row = static_cast<long long>(blockIdx.x) * n;
  F f(c0, c1, c2, c3, c4);
  zero_phase_pass<F, false>(f, x + row, y + row, n, smem);
  zero_phase_pass<F, true>(f, y + row, y + row, n, smem);
}

template <class F>
int launch_zero_phase(const double* x, double* y, int lanes, long long n,
                      double c0, double c1, double c2, double c3,
                      double c4, cudaStream_t s) {
  zero_phase_kernel<F><<<lanes, kZpThreads, 0, s>>>(x, y, n, c0, c1, c2,
                                                     c3, c4);
  return static_cast<int>(cudaGetLastError());
}

// The state scan's chain: AL in registers, the state s.  step() writes
// the pre-block state to *out (its slots past S zero), then s = AL s + p,
// row i ((s0*AL[i,0] + s1*AL[i,1]) + ...) + p[i].
template <typename T, int S>
struct StateChain {
  T a[S][S];
  T s[S];
  __device__ explicit StateChain(const T* al) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      s[i] = T(0);
#pragma unroll
      for (int k = 0; k < S; ++k) a[i][k] = al[i * S + k];
    }
  }
  __device__ __forceinline__ void step(const Quad<T>& p, Quad<T>* out) {
    Quad<T> pre;
#pragma unroll
    for (int i = 0; i < 4; ++i) pre.v[i] = i < S ? s[i] : T(0);
    *out = pre;
    T ns[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      T acc = mul_rn(s[0], a[i][0]);
#pragma unroll
      for (int k = 1; k < S; ++k) acc = add_rn(acc, mul_rn(s[k], a[i][k]));
      ns[i] = add_rn(acc, p.v[i]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) s[i] = ns[i];
  }
};

template <typename T>
__device__ __forceinline__ void read_quads(Quad<T> (&v)[kScanGroup],
                                           const Quad<T>* in) {
#pragma unroll
  for (int k = 0; k < kScanGroup; ++k) v[k] = in[k];
}

template <typename T, int S>
__device__ __forceinline__ void step_quads(StateChain<T, S>& f,
                                           const Quad<T> (&v)[kScanGroup],
                                           Quad<T>* out) {
#pragma unroll
  for (int k = 0; k < kScanGroup; ++k) f.step(v[k], out + k);
}

// The chain over m blocks of one chunk: block k's input at in[k], its
// pre-block state to out[k].  Two register groups in turn, as run_chain;
// a group past m steps on slots nobody reads (a chunk holds a multiple
// of 2 * kScanGroup blocks, and only a row's last chunk is short).
template <typename T, int S>
__device__ __forceinline__ void scan_chunk(StateChain<T, S>& f,
                                           const Quad<T>* in, Quad<T>* out,
                                           int m) {
  constexpr int G = kScanGroup;
  Quad<T> a[G], b[G];
  read_quads(a, in);
  for (int g = 0; g < m; g += 2 * G) {
    if (g + G < m) read_quads(b, in + g + G);
    step_quads(f, a, out + g);
    if (g + G >= m) break;
    if (g + 2 * G < m) read_quads(a, in + g + 2 * G);
    step_quads(f, b, out + g + G);
  }
}

// A block walks L lanes, `steps` blocks of each a chunk, lane l's from
// Quad l*pitch of a chunk buffer (see the design note).  Phase c:
// threads 0..L-1 of warp 0 walk chunk c; the helpers emit chunk c-1,
// start copying chunk c+2 and wait for chunk c+1.
template <typename T, int S>
__global__ void __launch_bounds__(kZpThreads)
state_scan_kernel(const T* __restrict__ p, const T* __restrict__ al,
                  T* __restrict__ states, int lanes, int nblk,
                  int L, int steps, int pitch) {
  constexpr int Q = kScanQuads<T>;
  __shared__ Quad<T> smem[(kScanIn + kScanOut) * Q];
  Quad<T>* in = smem;                   // chunk c in in[(c % 3) * Q]
  Quad<T>* out = smem + kScanIn * Q;    // chunk c in out[(c % 2) * Q]
  const int lane0 = static_cast<int>(blockIdx.x) * L;
  const int nl = min(L, lanes - lane0);
  const int chunks = (nblk + steps - 1) / steps;
  const int tid = static_cast<int>(threadIdx.x);
  const int h = tid - 32;               // helper index (warps 1-3)
  const long long row = static_cast<long long>(nblk) * S;

  auto span = [&](int c) { return min(steps, nblk - c * steps); };
  auto load = [&](int c) {              // chunk c of every lane, coalesced
    Quad<T>* r = in + (c % kScanIn) * Q;
    const int n = span(c) * S;
    for (int l = 0; l < nl; ++l) {
      const T* src = p + (lane0 + l) * row + static_cast<long long>(c) *
                         steps * S;
      for (int e = h; e < n; e += kHelpers) {
        const int j = e / S;
        copy_async(&r[l * pitch + j].v[e - j * S], src + e);
      }
    }
    commit_copies();
  };
  auto emit = [&](int c) {              // chunk c's states, coalesced
    const Quad<T>* o = out + (c % kScanOut) * Q;
    const int n = span(c) * S;
    for (int l = 0; l < nl; ++l) {
      T* dst = states + (lane0 + l) * row + static_cast<long long>(c) *
                        steps * S;
      for (int e = h; e < n; e += kHelpers) {
        const int j = e / S;
        dst[e] = o[l * pitch + j].v[e - j * S];
      }
    }
  };

  StateChain<T, S> f(al);
  if (h >= 0) {
    load(0);
    if (chunks > 1) load(1); else commit_copies();
    wait_all_but_last();
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (tid < nl) {
      scan_chunk(f, in + (c % kScanIn) * Q + tid * pitch,
                 out + (c % kScanOut) * Q + tid * pitch, span(c));
    } else if (h >= 0) {
      if (c > 0) emit(c - 1);
      if (c + 2 < chunks) load(c + 2); else commit_copies();
      wait_all_but_last();              // chunk c + 1 has landed
    }
    __syncthreads();
  }
  if (h >= 0) emit(chunks - 1);
}

// The current device's SM count, cached once a device (0 until then), as
// csrc/xorshift.cu caches its own.
constexpr int kMaxDevices = 64;
std::atomic<int> sms_of[kMaxDevices];

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sms_of[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) sms_of[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// Lanes a block: spread the lanes over the card's SMs, one a block while
// they fit, then up to kScanMaxLanes (warp 0's threads) a block.  Blocks
// a chunk: the ring's chunk buffer over those lanes, in whole pairs of
// register groups, with one Quad of padding a lane where there are
// several.
template <typename T, int S>
int launch_scan(const void* p, const void* al, void* states, int lanes,
                int nblk, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t rc = sm_count(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int spread = (lanes + sms - 1) / sms;
  const int per_block = spread < kScanMaxLanes ? spread : kScanMaxLanes;
  const int pad = per_block > 1 ? 1 : 0;
  const int steps = (kScanQuads<T> / per_block - pad) / (2 * kScanGroup) *
                    (2 * kScanGroup);
  const int grid = (lanes + per_block - 1) / per_block;
  state_scan_kernel<T, S><<<grid, kZpThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(al),
      static_cast<T*>(states), lanes, nblk, per_block, steps, steps + pad);
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
    return launch_zero_phase<Decimate>(xd, yd, lanes, n, c0, c1, c2, c3, c4,
                                       s);
  }
  if (kind == 1) {
    return launch_zero_phase<Biquad>(xd, yd, lanes, n, c0, c1, c2, c3, c4,
                                     s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
