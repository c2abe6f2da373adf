// Fused Adam update for Hopper (sm_90a), bound to Python through ctypes
// (tpuddp_torch/ops/fused_adam.py).
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
// host (the TPU kernel reads them from SMEM). p, m and v are updated in place.
//
// What bounds it: memory bandwidth. Each element reads p, g, m, v and writes
// p, m, v: 28 bytes for about 15 floating-point operations, far below the
// ~20 operations per byte where an H100's float32 units would become the
// limit. AlexNet with 10 classes has 57,044,810 parameters in 16 leaves, so
// one optimizer step moves 1.597 GB: 0.48 ms at the H100 SXM's 3.35 TB/s
// (less on a PCIe card), in 16 launches.
//
// Design: one launch per leaf, a grid-stride loop over its n elements, one
// element per thread per iteration; consecutive threads touch consecutive
// addresses, so every load and store is coalesced. No pad-to-(rows, 128)
// copies as on the TPU: the ragged tail is the loop bound. The TPU kernel's
// (512, 128) VMEM tiles have no counterpart; registers hold everything.
// Later work: one multi-tensor launch for all leaves and 16-byte loads.
//
// IEEE float32 throughout: build without --use_fast_math, which would change
// sqrtf and the divisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__global__ void fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                                  float* __restrict__ m, float* __restrict__ v,
                                  int64_t n, float lr, float b1, float one_minus_b1,
                                  float b2, float one_minus_b2, float eps,
                                  float weight_decay, float bc1, float bc2) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float pi = p[i];
    float gi = g[i];
    if (weight_decay != 0.0f) {
      gi = gi + weight_decay * pi;
    }
    const float mi = b1 * m[i] + one_minus_b1 * gi;
    const float vi = b2 * v[i] + one_minus_b2 * (gi * gi);
    m[i] = mi;
    v[i] = vi;
    p[i] = pi - lr * (mi / bc1) / (sqrtf(vi / bc2) + eps);
  }
}

}  // namespace

// Launches the update of one leaf of n > 0 float32 elements on `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpuddp_fused_adam(void* p, const void* g, void* m, void* v, int64_t n,
                                 float lr, float b1, float one_minus_b1, float b2,
                                 float one_minus_b2, float eps, float weight_decay,
                                 float bc1, float bc2, void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  fused_adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, lr, b1, one_minus_b1, b2, one_minus_b2, eps,
      weight_decay, bc1, bc2);
  return static_cast<int>(cudaGetLastError());
}
