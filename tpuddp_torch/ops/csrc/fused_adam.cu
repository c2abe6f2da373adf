// Fused Adam update for Hopper (sm_90a): every leaf of a parameter group in
// one launch. Bound to Python through ctypes (tpuddp_torch/ops/fused_adam.py).
//
// Replaces the Pallas TPU kernel tpuddp/ops/fused_adam.py::_adam_kernel
// (launched by _update_leaf, pl.pallas_call at tpuddp/ops/fused_adam.py:71).
// Same rule, plus the L2 term of tpuddp/optim.py's Adam (g += wd * p), so
// every Adam the port builds runs here:
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
// Two instantiations, on the type the moments are stored in:
// - float32 (tpuddp_fused_adam_multi): the kernel above, bitwise what it was
//   before the moment type became a template parameter.
// - bfloat16 (tpuddp_fused_adam_multi_bf16), for optimizer_state_dtype:
//   bfloat16. m and v are read as bf16 and widened to float32, the update
//   runs in the same float32 arithmetic, p is computed from the unrounded
//   float32 moments, and only then are m and v stored back to bf16 with the
//   JAX package's Weyl-sequence stochastic rounding (tpuddp/optim.py:79-130):
//
//     noise = (i * 0x9E3779B1 + t * 0x85EBCA77 + salt) mod 2^16
//     bf16  = (bits(x) + noise) mod 2^32 >> 16
//
//   with i the element's index within its leaf, t the leaf's step count and
//   salt = salt0 + 0x68E31DA4 * (k + 1) for the leaf's index k in the JAX
//   package's flattened parameter tree (salt0 0x5ADA0000 for m, 0x7EE70000
//   for v). The host folds t and salt into one word per moment
//   (Leaf::noise_m, Leaf::noise_v); the kernel adds i * 0x9E3779B1. `i`
//   counts the PyTorch layout of the leaf (OIHW, (out, in)), so for a conv
//   or linear weight the noise falls on other elements than in the JAX
//   package's layout: an equally valid, unbiased realisation
//   (tpuddp/optim.py:99-105), reproducible within a layout and bitwise equal
//   to JAX's for 1-D leaves.
//
// What bounds it: memory bandwidth. Each element reads p, g, m, v and writes
// p, m, v: 28 bytes with float32 moments (20 with bf16 ones) for about 15
// floating-point operations (and about 6 integer operations per bf16
// moment), far below the ~20 operations per byte where an H100's float32
// units would become the limit. AlexNet with 10 classes has 57,044,810
// parameters in 16 leaves, so one optimizer step moves 1.597 GB (1.141 GB):
// 0.477 ms (0.341 ms) at the H100 SXM's 3.35 TB/s.
//
// What the design does about it. The step's time is the time to stream
// those bytes, so the kernel has to keep every SM's loads in flight from the
// first byte to the last. AlexNet's leaves are very uneven: two classifier
// weights hold 95.6% of the bytes, and 14 leaves, down to a 10-element bias,
// the rest. A launch per leaf would pay ramp-up and drain on every SM for
// each small leaf, and 4-byte accesses keep few bytes in flight per thread.
// So:
// - One launch updates up to kMaxLeaves leaves. Their launch table (four
//   pointers, n, first chunk, bc1, bc2, an alignment flag and the two noise
//   words per leaf) is a __grid_constant__ kernel parameter passed by value:
//   no device buffer, no host-to-device copy, no synchronisation. Python
//   builds the table (fused_adam.launch_tables) and splits longer leaf lists
//   into several.
// - A launch captured into a CUDA graph cannot take its step's bc1, bc2 and
//   noise words by value: every replay would reuse the captured step's. Such
//   a launch passes Table::scalars, a device array of one LeafScalars per
//   row that the host refills before each replay
//   (tpuddp_torch/ops/device_scalars.py), and the kernel reads them from
//   there; an eager launch passes null and reads its rows. The values are the
//   same float32 and uint32 words either way, so the arithmetic is too.
// - Table::launches, when set, is a device word that thread 0 of block 0
//   adds one to: the count of launches that ran, eager ones and those a
//   graph replays alike, which the host cannot see launch by launch.
// - The guarded calling form (training.guard, the numerical guard's
//   firewall): Table::verdict points at an int32 on the device, 1 to apply
//   the update, 0 to skip it, set by the step from the aggregated gradient.
//   At 0 every block returns before its loads and writes nothing to p, m
//   or v (block 0 still counts the launch, so a skipped update is one
//   launch, as in the JAX package, whose lax.cond skips the kernel's work).
//   The step count is then the optimizer's one device count, as the TPU
//   kernel reads its bias corrections from device memory: t = *count + 1,
//   bc1 and bc2 from Table::bc[min(t, bc_len - 1)], a table the host builds
//   once with the host's float32 arithmetic up to where both are exactly 1
//   (fused_adam.bias_table), and the bf16 noise words the rows' step-free
//   parts plus t * 0x85EBCA77 (uint32, as noise_offset computes them). So
//   a guarded update of verdict 1 is bitwise the unguarded one at the same
//   count, and nothing the host uploads depends on a skip: the count
//   advances on the device (count += verdict, after the launch), inside a
//   CUDA-graph replay too. An unguarded launch passes null and is unchanged.
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
// - On a leaf whose p and g are 16-byte aligned and whose m and v are
//   aligned to four moments (16 bytes for float32, 8 for bf16), each thread
//   loads two groups of four elements of each of p, g, m and v (8 vector
//   loads in flight) before any arithmetic. Every load and store takes the
//   streaming, evict-first form (__ldcs, __stcs): each byte is touched once
//   per step, and a step moves some 20-30 times the 50 MB L2.
// - A chunk's n % 4 tail, and every element of a leaf with an unaligned
//   pointer (a view at an odd offset), take a scalar loop in the same kernel.
// - Element indices are 64-bit: a leaf may exceed 2^31 elements (the
//   rounding's `i` wraps at 2^32, as the JAX package's uint32 iota does).
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
  void* m;  // float32 or bf16, as the instantiation says
  void* v;
  int64_t n;
  int64_t chunk_start;  // first chunk of this leaf within the table
  float bc1;
  float bc2;
  int32_t aligned;   // 1 when p and g are 16-byte and m and v 4-moment aligned
  uint32_t noise_m;  // bf16 moments: (t * 0x85EBCA77 + salt of m) mod 2^32
  uint32_t noise_v;  // bf16 moments: (t * 0x85EBCA77 + salt of v) mod 2^32
};
static_assert(sizeof(Leaf) == 72, "Leaf layout");
static_assert(offsetof(Leaf, p) == 0, "Leaf layout");
static_assert(offsetof(Leaf, g) == 8, "Leaf layout");
static_assert(offsetof(Leaf, m) == 16, "Leaf layout");
static_assert(offsetof(Leaf, v) == 24, "Leaf layout");
static_assert(offsetof(Leaf, n) == 32, "Leaf layout");
static_assert(offsetof(Leaf, chunk_start) == 40, "Leaf layout");
static_assert(offsetof(Leaf, bc1) == 48, "Leaf layout");
static_assert(offsetof(Leaf, bc2) == 52, "Leaf layout");
static_assert(offsetof(Leaf, aligned) == 56, "Leaf layout");
static_assert(offsetof(Leaf, noise_m) == 60, "Leaf layout");
static_assert(offsetof(Leaf, noise_v) == 64, "Leaf layout");

// One row's per-step scalars, for a launch captured into a CUDA graph.
struct LeafScalars {
  float bc1;
  float bc2;
  uint32_t noise_m;
  uint32_t noise_v;
};
static_assert(sizeof(LeafScalars) == 16, "LeafScalars layout");

struct Table {
  const LeafScalars* scalars;    // null: each row's own bc1, bc2 and noise words
  unsigned long long* launches;  // null, or the word each launch adds one to
  const int32_t* verdict;        // null: unguarded; else 1 apply, 0 skip
  const int32_t* count;          // guarded: the optimizer's applied updates
  const float2* bc;              // guarded: (bc1, bc2) by step count t
  int64_t bc_len;                // guarded: rows of bc, the last (1, 1)
  int64_t n_chunks;
  int32_t n_leaves;
  Leaf leaves[kMaxLeaves];
};

struct Hyper {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

// Every CUDA version takes 4,096 bytes of kernel parameters; the table (3,520
// bytes with its five pointers and bc_len) stays within them.
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

// Moment storage. The float32 overloads are the plain streaming loads and
// stores; the bf16 ones (a moment held as its 16 bits) widen on load and
// round stochastically on store. `i` is the element's index within its leaf.
__device__ __forceinline__ float4 load4(const float* m) {
  return __ldcs(reinterpret_cast<const float4*>(m));
}
__device__ __forceinline__ float load1(const float* m) { return __ldcs(m); }
__device__ __forceinline__ void store4(float* m, const float4& x, int64_t, uint32_t) {
  __stcs(reinterpret_cast<float4*>(m), x);
}
__device__ __forceinline__ void store1(float* m, float x, int64_t, uint32_t) { __stcs(m, x); }

__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
// tpuddp/optim.py:107-117: add sub-ulp Weyl noise to the float32 bits, keep
// the upper 16. uint32 arithmetic wraps as the JAX package's does.
__device__ __forceinline__ unsigned short round_bf16(float x, int64_t i, uint32_t noise0) {
  const uint32_t noise = (static_cast<uint32_t>(i) * 0x9E3779B1u + noise0) & 0xFFFFu;
  return static_cast<unsigned short>((__float_as_uint(x) + noise) >> 16);
}
__device__ __forceinline__ float4 load4(const unsigned short* m) {
  const ushort4 b = __ldcs(reinterpret_cast<const ushort4*>(m));
  return make_float4(widen(b.x), widen(b.y), widen(b.z), widen(b.w));
}
__device__ __forceinline__ float load1(const unsigned short* m) { return widen(__ldcs(m)); }
__device__ __forceinline__ void store4(unsigned short* m, const float4& x, int64_t i,
                                       uint32_t noise0) {
  __stcs(reinterpret_cast<ushort4*>(m),
         make_ushort4(round_bf16(x.x, i, noise0), round_bf16(x.y, i + 1, noise0),
                      round_bf16(x.z, i + 2, noise0), round_bf16(x.w, i + 3, noise0)));
}
__device__ __forceinline__ void store1(unsigned short* m, float x, int64_t i, uint32_t noise0) {
  __stcs(m, round_bf16(x, i, noise0));
}

// One block per chunk: block c updates chunk c of the table. M is the
// moments' storage: float, or unsigned short for bf16 bits.
template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ Table table, const int64_t chunk,
                        const Hyper h) {
  const int64_t c = blockIdx.x;
  if (c == 0 && threadIdx.x == 0 && table.launches != nullptr) {
    atomicAdd(table.launches, 1ull);
  }
  if (table.verdict != nullptr && *table.verdict == 0) {
    return;  // a skipped update: nothing loaded, nothing written
  }
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
  float bc1 = leaf.bc1;
  float bc2 = leaf.bc2;
  uint32_t noise_m = leaf.noise_m;
  uint32_t noise_v = leaf.noise_v;
  if (table.scalars != nullptr) {
    const LeafScalars s = table.scalars[lo];
    bc1 = s.bc1;
    bc2 = s.bc2;
    noise_m = s.noise_m;
    noise_v = s.noise_v;
  }
  if (table.verdict != nullptr) {
    // the step count from the device; the rows hold the noise words'
    // step-free parts (uint32 arithmetic wraps as noise_offset's)
    const uint32_t t = static_cast<uint32_t>(*table.count) + 1u;
    const float2 b = table.bc[t < table.bc_len ? static_cast<int64_t>(t) : table.bc_len - 1];
    bc1 = b.x;
    bc2 = b.y;
    noise_m += t * 0x85EBCA77u;
    noise_v += t * 0x85EBCA77u;
  }
  M* const mp = static_cast<M*>(leaf.m);
  M* const vp = static_cast<M*>(leaf.v);

  int64_t scalar_begin = begin;
  if (leaf.aligned) {
    float4* p4 = reinterpret_cast<float4*>(leaf.p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(leaf.g + begin);
    const int64_t groups = (end - begin) / 4;
    for (int64_t j = threadIdx.x; j < groups; j += 2 * kThreads) {
      const int64_t k = j + kThreads;
      const bool second = k < groups;
      const int64_t i0 = begin + 4 * j;  // element index within the leaf
      const int64_t i1 = begin + 4 * k;
      // all eight vector loads before any arithmetic
      float4 p0 = __ldcs(p4 + j), g0 = __ldcs(g4 + j);
      float4 m0 = load4(mp + i0), v0 = load4(vp + i0);
      float4 p1, g1, m1, v1;
      if (second) {
        p1 = __ldcs(p4 + k);
        g1 = __ldcs(g4 + k);
        m1 = load4(mp + i1);
        v1 = load4(vp + i1);
      }
      adam4(p0, g0, m0, v0, h, bc1, bc2);
      __stcs(p4 + j, p0);
      store4(mp + i0, m0, i0, noise_m);
      store4(vp + i0, v0, i0, noise_v);
      if (second) {
        adam4(p1, g1, m1, v1, h, bc1, bc2);
        __stcs(p4 + k, p1);
        store4(mp + i1, m1, i1, noise_m);
        store4(vp + i1, v1, i1, noise_v);
      }
    }
    scalar_begin = begin + groups * 4;
  }
  for (int64_t i = scalar_begin + threadIdx.x; i < end; i += kThreads) {
    float p = __ldcs(leaf.p + i);
    const float g = __ldcs(leaf.g + i);
    float m = load1(mp + i);
    float v = load1(vp + i);
    adam(p, g, m, v, h, bc1, bc2);
    __stcs(leaf.p + i, p);
    store1(mp + i, m, i, noise_m);
    store1(vp + i, v, i, noise_v);
  }
}

// Launches the update of the n_leaves (1..kMaxLeaves) leaves described by
// `leaves`, a host array of Leaf rows whose chunk starts are the prefix sums
// of ceil(n / chunk) from 0, on `stream`. The rows are copied into the
// kernel's parameters, so the array may be freed when this returns. `chunk`
// is a positive multiple of 4. `scalars` is null, or a device array of
// n_leaves LeafScalars that replaces the rows' bc1, bc2 and noise words;
// `launches` is null or a device word the launch adds one to. `verdict` is
// null (unguarded), or with `count` a device int32 each and `bc` a device
// array of bc_len (bc1, bc2) pairs the guarded form (see the header).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
template <typename M>
int launch(const void* leaves, int n_leaves, int64_t chunk, const void* scalars,
           void* launches, const void* verdict, const void* count, const void* bc,
           int64_t bc_len, float lr, float b1, float one_minus_b1, float b2,
           float one_minus_b2, float eps, float weight_decay, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk <= 0 || chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (verdict != nullptr && (count == nullptr || bc == nullptr || bc_len < 1 ||
                             scalars != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaves, leaves, static_cast<size_t>(n_leaves) * sizeof(Leaf));
  table.n_leaves = n_leaves;
  table.scalars = static_cast<const LeafScalars*>(scalars);
  table.launches = static_cast<unsigned long long*>(launches);
  table.verdict = static_cast<const int32_t*>(verdict);
  table.count = static_cast<const int32_t*>(count);
  table.bc = static_cast<const float2*>(bc);
  table.bc_len = bc_len;
  const Leaf& last = table.leaves[n_leaves - 1];
  table.n_chunks = last.chunk_start + (last.n + chunk - 1) / chunk;

  if (table.n_chunks > INT32_MAX) {  // the grid's x extent
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  fused_adam_multi_kernel<M><<<static_cast<unsigned int>(table.n_chunks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(table, chunk, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 moments: m and v are float* in every row.
extern "C" int tpuddp_fused_adam_multi(const void* leaves, int n_leaves, int64_t chunk,
                                       const void* scalars, void* launches,
                                       const void* verdict, const void* count, const void* bc,
                                       int64_t bc_len, float lr, float b1, float one_minus_b1,
                                       float b2, float one_minus_b2, float eps,
                                       float weight_decay, void* stream) {
  return launch<float>(leaves, n_leaves, chunk, scalars, launches, verdict, count, bc, bc_len,
                       lr, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, stream);
}

// bf16 moments: m and v point at bf16 arrays; noise_m and noise_v are set.
extern "C" int tpuddp_fused_adam_multi_bf16(const void* leaves, int n_leaves, int64_t chunk,
                                            const void* scalars, void* launches,
                                            const void* verdict, const void* count,
                                            const void* bc, int64_t bc_len, float lr,
                                            float b1, float one_minus_b1, float b2,
                                            float one_minus_b2, float eps, float weight_decay,
                                            void* stream) {
  return launch<unsigned short>(leaves, n_leaves, chunk, scalars, launches, verdict, count, bc,
                                bc_len, lr, b1, one_minus_b1, b2, one_minus_b2, eps,
                                weight_decay, stream);
}
