// Batched KL-UCB / KL-LCB of empirical Bernoulli means, one thread per element.
//
// Replaces the Pallas TPU kernel rl_agents_tpu/ops/pallas_kl.py::_kl_bound_kernel
// (body :40-72, launched by kl_bound_pallas :75-109) and computes exactly what it
// computes: for mu = sum / max(n, 1) and d = threshold / max(n, 1), solve
// KL(Bern(mu) || Bern(q)) = d for q in [mu, 1] (or [0, mu] when `lower`) by a
// guarded Newton iteration from the midpoint. A non-finite step keeps x; a step
// that leaves [a, b] becomes 0.9 * bound + 0.1 * x. At most `iters` trips; an
// element freezes after the first step with |dx| <= eps. Then clip to [a, b],
// return a when a == b, and 1 (upper) or 0 (lower) when n == 0.
//
// What bounds it on an H100: each element reads 12 bytes and writes 4, and its
// Newton chain (two logf and three divisions a trip) runs a handful of trips in
// registers, so at large n the kernel is bound by memory bytes; at the planner's
// n = 4096 trees it is bound by launch latency. The design keeps everything
// that is not the 16 bytes out of device memory: 3 loads, every trip in
// registers, 1 store, and a thread stops as soon as its element froze (a frozen
// x never changes again). The Pallas version's (rows, 128) padding, f32 freeze
// mask and VMEM tiling were Mosaic workarounds and have no counterpart here.
//
// Numerics: built without --use_fast_math, so logf, division, inf and nan keep
// IEEE semantics (the guards below depend on them), and with --fmad=false, so
// every product and sum rounds on its own as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kOobWeight = 0.9f;
// 1 - 0.9 taken in double and then rounded to float, as the f32 reference does.
constexpr float kOobKeep = static_cast<float>(1.0 - 0.9);

__device__ __forceinline__ float bernoulli_kl(float p, float q) {
  float kl1 = (p > 0.f && q > 0.f) ? p * logf(p / q) : 0.f;
  float kl2;
  if (q < 1.f) {
    kl2 = (p < 1.f) ? (1.f - p) * logf((1.f - p) / (1.f - q)) : 0.f;
  } else {
    kl2 = (p < 1.f) ? INFINITY : 0.f;
  }
  if (p > 0.f && q <= 0.f) kl1 = INFINITY;
  return kl1 + kl2;
}

__device__ __forceinline__ float d_bernoulli_kl_dq(float p, float q) {
  return (1.f - p) / (1.f - q) - p / q;
}

__global__ void kl_bound_kernel(const float* __restrict__ sum,
                                const float* __restrict__ count,
                                const float* __restrict__ threshold,
                                float* __restrict__ out, long long size,
                                bool lower, int iters, float eps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const float n = count[i];
    const float safe = (n < 1.f) ? 1.f : n;
    const float mu = sum[i] / safe;
    const float max_div = threshold[i] / safe;
    const float a = lower ? 0.f : mu;
    const float b = lower ? mu : 1.f;
    float x = (a + b) / 2.f;
    for (int it = 0; it < iters; ++it) {
      const float f = bernoulli_kl(mu, x) - max_div;
      const float df = d_bernoulli_kl_dq(mu, x);
      float x_next = (df != 0.f) ? x - f / df : x;
      if (!isfinite(x_next)) x_next = x;
      if (x_next < a) x_next = kOobWeight * a + kOobKeep * x;
      if (x_next > b) x_next = kOobWeight * b + kOobKeep * x;
      const bool frozen = fabsf(x_next - x) <= eps;
      x = x_next;
      if (frozen) break;
    }
    x = (x < a) ? a : x;
    x = (x > b) ? b : x;
    if (a == b) x = a;
    out[i] = (n == 0.f) ? (lower ? 0.f : 1.f) : x;
  }
}

}  // namespace

// Launch on `stream` over `size` contiguous float32 elements. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int kl_bound_launch(const float* sum, const float* count,
                               const float* threshold, float* out,
                               long long size, int lower, int iters, float eps,
                               void* stream) {
  if (size <= 0) return 0;
  constexpr int kThreads = 128;
  constexpr long long kMaxBlocks = 1LL << 20;  // the grid-stride loop covers the rest
  long long blocks = (size + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kl_bound_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      sum, count, threshold, out, size, lower != 0, iters, eps);
  return static_cast<int>(cudaGetLastError());
}
