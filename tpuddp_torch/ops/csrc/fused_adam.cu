// Fused Adam update for Hopper (sm_90a): every leaf of a parameter group in
// one launch. Bound to Python through ctypes (tpuddp_torch/ops/fused_adam.py).
//
// Replaces the Pallas TPU kernel tpuddp/ops/fused_adam.py::_adam_kernel
// (launched by _update_leaf, pl.pallas_call at tpuddp/ops/fused_adam.py:71).
// Same rule, plus the L2 term of tpuddp/optim.py's Adam (g += wd * p), so
// every float32 Adam the port builds runs here:
//
//   g <- g + wd * p                       (only when wd != 0)
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
//
// bc1 = 1 - b1^t and bc2 = 1 - b2^t arrive as float32 scalars computed on the
// host (the TPU kernel reads them from SMEM), one pair per leaf: each
// parameter keeps its own step count. p, m and v are updated in place.
//
// What bounds it: memory bandwidth. Each element reads p, g, m, v and writes
// p, m, v: 28 bytes for about 15 floating-point operations, far below the
// ~20 operations per byte where an H100's float32 units would become the
// limit. AlexNet with 10 classes has 57,044,810 parameters in 16 leaves, so
// one optimizer step moves 1.597 GB: 0.477 ms at the H100 SXM's 3.35 TB/s.
//
// What the design does about it. The step's time is the time to stream
// those bytes, so the kernel has to keep every SM's loads in flight from the
// first byte to the last. AlexNet's leaves are very uneven: two classifier
// weights hold 95.6% of the bytes, and 14 leaves, down to a 10-element bias,
// the rest. A launch per leaf would pay ramp-up and drain on every SM for
// each small leaf, and 4-byte accesses keep few bytes in flight per thread.
// So:
// - One launch updates up to kMaxLeaves leaves. Their launch table (four
//   pointers, n, first chunk, bc1, bc2 and an alignment flag per leaf) is a
//   __grid_constant__ kernel parameter passed by value: no device buffer, no
//   host-to-device copy, no synchronisation. Python builds the table
//   (fused_adam.launch_tables) and splits longer leaf lists into several.
// - The leaves are cut into chunks of `chunk` elements, numbered across the
//   table, and the grid has one block per chunk. A block finds its chunk's
//   leaf by binary search over the chunk starts (at most 6 steps for 48
//   leaves, on uniform parameter loads). Because the block scheduler hands
//   chunks to SMs as they free up, the uneven leaves and their partial last
//   chunks balance themselves; a persistent grid (resident blocks x SMs)
//   walking the chunks in a grid-stride loop was slower on an H100 at every
//   chunk size tried, since its static share of chunks per block left a
//   tail. The chunk size (fused_adam.CHUNK) was chosen on the card with
//   tpuddp_torch/ops/tune_chunk.py.
// - On a leaf whose four pointers are 16-byte aligned, each thread loads two
//   float4 groups of each of p, g, m and v (8 x 16 B in flight) before any
//   arithmetic. Every load and store takes the streaming, evict-first form
//   (__ldcs, __stcs): each byte is touched once per step, and a step moves
//   some 30 times the 50 MB L2.
// - A chunk's n % 4 tail, and every element of a leaf with an unaligned
//   pointer (a view at an odd offset), take a scalar loop in the same kernel.
// - Element indices are 64-bit: a leaf may exceed 2^31 elements.
//
// IEEE float32 throughout, in the operation order above for every element,
// with the roundings written out in adam() below.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 48;

// One row of the launch table. LEAF_DTYPE in tpuddp_torch/ops/fused_adam.py
// matches it byte for byte; the CPU tests read these static_asserts.
struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int64_t chunk_start;  // first chunk of this leaf within the table
  float bc1;
  float bc2;
  int32_t aligned;  // 1 when p, g, m and v are all 16-byte aligned
};
static_assert(sizeof(Leaf) == 64, "Leaf layout");
static_assert(offsetof(Leaf, p) == 0, "Leaf layout");
static_assert(offsetof(Leaf, g) == 8, "Leaf layout");
static_assert(offsetof(Leaf, m) == 16, "Leaf layout");
static_assert(offsetof(Leaf, v) == 24, "Leaf layout");
static_assert(offsetof(Leaf, n) == 32, "Leaf layout");
static_assert(offsetof(Leaf, chunk_start) == 40, "Leaf layout");
static_assert(offsetof(Leaf, bc1) == 48, "Leaf layout");
static_assert(offsetof(Leaf, bc2) == 52, "Leaf layout");
static_assert(offsetof(Leaf, aligned) == 56, "Leaf layout");

struct Table {
  int64_t n_chunks;
  int32_t n_leaves;
  Leaf leaves[kMaxLeaves];
};

struct Hyper {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

// Every CUDA version takes 4,096 bytes of kernel parameters; the table stays
// within them.
static_assert(sizeof(Table) + sizeof(int64_t) + sizeof(Hyper) <= 4096,
              "kernel parameters exceed 4 KB");

// One element. Every rounding is spelled out: the L2 term and the two moment
// updates are fused multiply-adds (one rounding each), every other operation
// rounds once. Left to itself, nvcc may contract `a * b + c * d` either way,
// and differently in the four lanes of a float4; spelled out, every element
// rounds the same way at every width.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Hyper& h, float bc1, float bc2) {
  if (h.weight_decay != 0.0f) {
    g = __fmaf_rn(h.weight_decay, p, g);
  }
  m = __fmaf_rn(h.b1, m, __fmul_rn(h.one_minus_b1, g));
  v = __fmaf_rn(h.b2, v, __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float step = __fmul_rn(h.lr, __fdiv_rn(m, bc1));
  p = __fsub_rn(p, __fdiv_rn(step, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps)));
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Hyper& h, float bc1, float bc2) {
  adam(p.x, g.x, m.x, v.x, h, bc1, bc2);
  adam(p.y, g.y, m.y, v.y, h, bc1, bc2);
  adam(p.z, g.z, m.z, v.z, h, bc1, bc2);
  adam(p.w, g.w, m.w, v.w, h, bc1, bc2);
}

// One block per chunk: block c updates chunk c of the table.
__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ Table table, const int64_t chunk,
                        const Hyper h) {
  const int64_t c = blockIdx.x;
  // the leaf holding chunk c: the last one whose first chunk is <= c
  int lo = 0;
  int hi = table.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaves[mid].chunk_start <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& leaf = table.leaves[lo];
  const int64_t begin = (c - leaf.chunk_start) * chunk;  // a multiple of 4
  const int64_t end = begin + chunk < leaf.n ? begin + chunk : leaf.n;
  const float bc1 = leaf.bc1;
  const float bc2 = leaf.bc2;

  int64_t scalar_begin = begin;
  if (leaf.aligned) {
    float4* p4 = reinterpret_cast<float4*>(leaf.p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(leaf.g + begin);
    float4* m4 = reinterpret_cast<float4*>(leaf.m + begin);
    float4* v4 = reinterpret_cast<float4*>(leaf.v + begin);
    const int64_t groups = (end - begin) / 4;
    for (int64_t j = threadIdx.x; j < groups; j += 2 * kThreads) {
      const int64_t k = j + kThreads;
      const bool second = k < groups;
      // all eight 16-byte loads before any arithmetic
      float4 p0 = __ldcs(p4 + j), g0 = __ldcs(g4 + j);
      float4 m0 = __ldcs(m4 + j), v0 = __ldcs(v4 + j);
      float4 p1, g1, m1, v1;
      if (second) {
        p1 = __ldcs(p4 + k);
        g1 = __ldcs(g4 + k);
        m1 = __ldcs(m4 + k);
        v1 = __ldcs(v4 + k);
      }
      adam4(p0, g0, m0, v0, h, bc1, bc2);
      __stcs(p4 + j, p0);
      __stcs(m4 + j, m0);
      __stcs(v4 + j, v0);
      if (second) {
        adam4(p1, g1, m1, v1, h, bc1, bc2);
        __stcs(p4 + k, p1);
        __stcs(m4 + k, m1);
        __stcs(v4 + k, v1);
      }
    }
    scalar_begin = begin + groups * 4;
  }
  for (int64_t i = scalar_begin + threadIdx.x; i < end; i += kThreads) {
    float p = __ldcs(leaf.p + i);
    const float g = __ldcs(leaf.g + i);
    float m = __ldcs(leaf.m + i);
    float v = __ldcs(leaf.v + i);
    adam(p, g, m, v, h, bc1, bc2);
    __stcs(leaf.p + i, p);
    __stcs(leaf.m + i, m);
    __stcs(leaf.v + i, v);
  }
}

}  // namespace

// Launches the update of the n_leaves (1..48) leaves described by `leaves`,
// a host array of Leaf rows whose chunk starts are the prefix sums of
// ceil(n / chunk) from 0, on `stream`. The rows are copied into the kernel's
// parameters, so the array may be freed when this returns. `chunk` is a
// positive multiple of 4. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it cannot take.
extern "C" int tpuddp_fused_adam_multi(const void* leaves, int n_leaves, int64_t chunk,
                                       float lr, float b1, float one_minus_b1, float b2,
                                       float one_minus_b2, float eps, float weight_decay,
                                       void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk <= 0 || chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaves, leaves, static_cast<size_t>(n_leaves) * sizeof(Leaf));
  table.n_leaves = n_leaves;
  const Leaf& last = table.leaves[n_leaves - 1];
  table.n_chunks = last.chunk_start + (last.n + chunk - 1) / chunk;

  if (table.n_chunks > INT32_MAX) {  // the grid's x extent
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  fused_adam_multi_kernel<<<static_cast<unsigned int>(table.n_chunks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(table, chunk, h);
  return static_cast<int>(cudaGetLastError());
}
