// Batched KL-UCB / KL-LCB of empirical Bernoulli means, one thread per element,
// in two launch forms over one device solve.
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
// The two forms:
// - dense (kl_bound_launch): three f32 arrays of one shape in, one out. Each
//   element reads 12 bytes and writes 4, and its Newton chain (two logf and
//   three divisions a trip) runs a handful of trips in registers, so at large
//   n it is bound by memory bytes.
// - indexed (kl_bound_indexed_launch): the OLOP planner's form. It solves the
//   nodes of one whole episode's path, nodes[h, b] of a [B, N] tree arena,
//   reading sum[b, nodes[h, b]] and count[b, nodes[h, b]] (i64, converted
//   here) and writing out[b, nodes[h, b]] in place, with one scalar threshold.
//   At the planner's 8 x 4096 path nodes it moves under a megabyte, so it is
//   bound by launch latency and by the longest Newton chain of a warp.
//
// What the design does about it: one launch per OLOP episode instead of one
// per (episode, depth) step, with the gathers and the scatter done here and
// no broadcast or copy of the threshold; lanes mapped depth-major (element i
// is (h = i / B, b = i % B)), so the index loads coalesce and a warp holds
// nodes of one depth across 32 trees, whose similar counts give similar trip
// counts; a grid of one element per thread (256 blocks of 128 at the
// planner's shape) spread over the 132 SMs; every trip in registers, and a
// thread stops once its element froze (a frozen x never changes again) or
// skips the loop where its result would be discarded (n == 0, a == b). The
// Pallas version's (rows, 128) padding, f32 freeze mask and VMEM tiling were
// Mosaic workarounds and have no counterpart here.
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
constexpr int kThreads = 128;  // 256 blocks at the planner's 8 x 4096 path nodes
constexpr long long kMaxBlocks = 1LL << 20;  // the grid-stride loops cover the rest

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

// The bound of one element: what both launch forms run.
__device__ __forceinline__ float kl_solve(float total, float n, float threshold, bool lower,
                                          int iters, float eps) {
  if (n == 0.f) return lower ? 0.f : 1.f;
  const float safe = (n < 1.f) ? 1.f : n;
  const float mu = total / safe;
  const float a = lower ? 0.f : mu;
  const float b = lower ? mu : 1.f;
  if (a == b) return a;
  const float max_div = threshold / safe;
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
  return (x > b) ? b : x;
}

__global__ void kl_bound_kernel(const float* __restrict__ sum,
                                const float* __restrict__ count,
                                const float* __restrict__ threshold,
                                float* __restrict__ out, long long size,
                                bool lower, int iters, float eps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    out[i] = kl_solve(sum[i], count[i], threshold[i], lower, iters, eps);
  }
}

__global__ void kl_bound_indexed_kernel(const float* __restrict__ sum,
                                        const long long* __restrict__ count,
                                        const long long* __restrict__ nodes,
                                        const float* __restrict__ threshold,
                                        float* __restrict__ out, long long trees,
                                        long long width, long long size, bool lower,
                                        int iters, float eps) {
  const float thr = *threshold;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const long long node = nodes[i];
    // a node outside its tree's row stops the kernel with an error, as an
    // out-of-range index_put_ would, instead of writing outside the arena
    if (static_cast<unsigned long long>(node) >= static_cast<unsigned long long>(width)) __trap();
    const long long at = (i % trees) * width + node;
    out[at] = kl_solve(sum[at], static_cast<float>(count[at]), thr, lower, iters, eps);
  }
}

unsigned int grid_for(long long size) {
  long long blocks = (size + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Launch on `stream` over `size` contiguous float32 elements. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int kl_bound_launch(const float* sum, const float* count,
                               const float* threshold, float* out,
                               long long size, int lower, int iters, float eps,
                               void* stream) {
  if (size <= 0) return 0;
  kl_bound_kernel<<<grid_for(size), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sum, count, threshold, out, size, lower != 0, iters, eps);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` over the `size` = H * trees entries of the row-major
// nodes [H, trees], each in [0, width); sum, count and out are row-major
// [trees, width]. A node repeated in one tree is solved twice from the same
// inputs and gets the same value. Returns the cudaError_t of the launch.
extern "C" int kl_bound_indexed_launch(const float* sum, const long long* count,
                                       const long long* nodes, const float* threshold,
                                       float* out, long long trees, long long width,
                                       long long size, int lower, int iters, float eps,
                                       void* stream) {
  if (size <= 0) return 0;
  kl_bound_indexed_kernel<<<grid_for(size), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      sum, count, nodes, threshold, out, trees, width, size, lower != 0, iters, eps);
  return static_cast<int>(cudaGetLastError());
}
