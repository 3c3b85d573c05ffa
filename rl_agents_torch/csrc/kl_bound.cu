// Batched KL-UCB / KL-LCB of empirical Bernoulli means, one thread per element,
// in three launch forms over one device solve.
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
// The three forms:
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
// - paired (kl_bounds_pair_launch): the MDP-GapE and stochastic GBOP form. It
//   reads sum[at] and count[at] (i64) at the flat offsets at[i] of tree i % B
//   in [B, ...] arenas, solves the upper AND the lower bound of each element
//   and writes ucb[at] and lcb[at] in place, under an optional per-tree mask.
//   The threshold is a scalar or a table indexed by the element's count, read
//   on the device. MDP-GapE launches it once per episode over its path
//   [H, B] (5 x 4096 elements), stochastic GBOP once per step (4096 or 512).
//   Those sizes move well under a megabyte: the launch, the index loads and
//   the longest pair of Newton chains of a warp bound it.
//
// What the design does about it: one launch per OLOP or MDP-GapE episode
// (per GBOP step, for both bounds) instead of one or two per (episode, depth)
// step, with the gathers and the scatters done here and no broadcast or copy
// of the threshold; lanes mapped depth-major (element i
// is (h = i / B, b = i % B)), so the index loads coalesce and a warp holds
// nodes of one depth across 32 trees, whose similar counts give similar trip
// counts; a grid of one element per thread (256 blocks of 128 at the
// planner's shape) spread over the 132 SMs; every trip in registers, and a
// thread stops once its element froze (a frozen x never changes again) or
// skips the loop where its result would be discarded (n == 0, a == b). The
// Pallas version's (rows, 128) padding, f32 freeze mask and VMEM tiling were
// Mosaic workarounds and have no counterpart here.
//
// The paired form, further: one thread runs both chains. They share mu, the
// divergence and the set-up loads and are independent of each other, so one
// loop steps both, each with its own freeze, their operations written side by
// side and no branch around a log, so that the logf / division latency of one
// chain hides the other's (each IEEE division keeps a branch to its slow path,
// which bounds the overlap); a chain that froze (or never needed the loop:
// n == 0, or its interval is a point) keeps its value while the other runs on.
// Blocks are sized from the SM count so that the planners' 512 to 20,480
// elements spread over the SMs (one warp a block up to 32 x SMs elements,
// then up to four), with the same depth-major lanes.
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
constexpr int kPairMaxThreads = 128;  // the paired form's largest block: four warps
constexpr int kMaxDevices = 64;

// KL(Bern(p) || Bern(q)) from r = p / q and s = (1 - p) / (1 - q): both logs are
// taken and the needed terms selected, so no branch guards a log and the logs of
// two chains can be scheduled together. The selected values are those of the
// guarded formula (reference utils.py:89-107).
__device__ __forceinline__ float kl_from_ratios(float p, float q, float r, float s) {
  const float l1 = logf(r);
  const float l2 = logf(s);
  float kl1 = (p > 0.f && q > 0.f) ? p * l1 : 0.f;
  const float kl2 = (q < 1.f) ? ((p < 1.f) ? (1.f - p) * l2 : 0.f) : ((p < 1.f) ? INFINITY : 0.f);
  if (p > 0.f && q <= 0.f) kl1 = INFINITY;
  return kl1 + kl2;
}

// The guards of a Newton step from x: a non-finite step keeps x, one that
// leaves [a, b] is pulled back towards the bound it crossed.
__device__ __forceinline__ float guard(float x, float x_next, float a, float b) {
  if (!isfinite(x_next)) x_next = x;
  if (x_next < a) x_next = kOobWeight * a + kOobKeep * x;
  if (x_next > b) x_next = kOobWeight * b + kOobKeep * x;
  return x_next;
}

// One guarded Newton step of KL(mu, x) = max_div on [a, b]; dKL/dq is s - r.
__device__ __forceinline__ float newton_step(float mu, float max_div, float a, float b,
                                             float x) {
  const float r = mu / x, s = (1.f - mu) / (1.f - x);
  const float f = kl_from_ratios(mu, x, r, s) - max_div, df = s - r;
  const float q = f / df;
  return guard(x, (df != 0.f) ? x - q : x, a, b);
}

__device__ __forceinline__ float clip_to(float x, float a, float b) {
  x = (x < a) ? a : x;
  return (x > b) ? b : x;
}

// The bound of one element: what the dense and the indexed form run.
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
    const float x_next = newton_step(mu, max_div, a, b, x);
    const bool frozen = fabsf(x_next - x) <= eps;
    x = x_next;
    if (frozen) break;
  }
  return clip_to(x, a, b);
}

// Both bounds of one element: what the paired form runs. One trip steps both
// chains, each operation of the upper chain written beside the same one of
// the lower (newton_step's arithmetic, interleaved), so that the divisions
// and logs of one chain overlap the other's. Each chain takes exactly the
// steps kl_solve takes for it and keeps its value once it froze, so each
// result equals kl_solve's bit for bit.
__device__ __forceinline__ void kl_solve_pair(float total, float n, float threshold, int iters,
                                              float eps, float* upper, float* lower) {
  if (n == 0.f) {
    *upper = 1.f;
    *lower = 0.f;
    return;
  }
  const float safe = (n < 1.f) ? 1.f : n;
  const float mu = total / safe;
  const float max_div = threshold / safe;
  // upper on [mu, 1], lower on [0, mu]; a chain whose interval is a point is done
  const bool upper_point = (mu == 1.f);
  const bool lower_point = (0.f == mu);
  float xu = (mu + 1.f) / 2.f;
  float xl = (0.f + mu) / 2.f;
  bool du = upper_point, dl = lower_point;
  const float rest = 1.f - mu;
  for (int it = 0; it < iters && !(du && dl); ++it) {
    const float ru = mu / xu, rl = mu / xl;
    const float su = rest / (1.f - xu), sl = rest / (1.f - xl);
    const float fu = kl_from_ratios(mu, xu, ru, su) - max_div;
    const float fl = kl_from_ratios(mu, xl, rl, sl) - max_div;
    const float dfu = su - ru, dfl = sl - rl;
    const float qu = fu / dfu, ql = fl / dfl;
    const float nu = guard(xu, (dfu != 0.f) ? xu - qu : xu, mu, 1.f);
    const float nl = guard(xl, (dfl != 0.f) ? xl - ql : xl, 0.f, mu);
    const bool zu = fabsf(nu - xu) <= eps, zl = fabsf(nl - xl) <= eps;
    xu = du ? xu : nu;
    xl = dl ? xl : nl;
    du = du || zu;
    dl = dl || zl;
  }
  *upper = upper_point ? mu : clip_to(xu, mu, 1.f);
  *lower = lower_point ? 0.f : clip_to(xl, 0.f, mu);
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

__global__ void __launch_bounds__(kPairMaxThreads)
kl_bounds_pair_kernel(const float* __restrict__ sum, const long long* __restrict__ count,
                      const long long* __restrict__ at, const bool* __restrict__ mask,
                      const float* __restrict__ threshold, long long table,
                      float* __restrict__ ucb, float* __restrict__ lcb, long long trees,
                      long long width, long long size, int iters, float eps) {
  const float scalar = (table == 0) ? *threshold : 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const long long tree = i % trees;
    if (mask != nullptr && !mask[tree]) continue;
    const long long offset = at[i];
    // an offset outside its tree's row, or a count outside the threshold
    // table, stops the kernel with an error, as an out-of-range index would
    if (static_cast<unsigned long long>(offset) >= static_cast<unsigned long long>(width)) __trap();
    const long long k = tree * width + offset;
    const long long n = count[k];
    float thr = scalar;
    if (table != 0) {
      if (static_cast<unsigned long long>(n) >= static_cast<unsigned long long>(table)) __trap();
      thr = threshold[n];
    }
    float upper, lower;
    kl_solve_pair(sum[k], static_cast<float>(n), thr, iters, eps, &upper, &lower);
    ucb[k] = upper;
    lcb[k] = lower;
  }
}

unsigned int grid_for(long long size) {
  long long blocks = (size + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// The current device's SM count, read once per device.
int sm_count() {
  static int counts[kMaxDevices] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    counts[device] = sms > 0 ? sms : 132;
  }
  return counts[device];
}

// One warp a block while there are at most 32 elements an SM, then more warps
// a block (up to four), so that a launch of the planners' sizes covers the SMs.
unsigned int pair_threads(long long size) {
  const long long per_sm = 32LL * sm_count();
  long long warps = (size + per_sm - 1) / per_sm;
  const long long most = kPairMaxThreads / 32;
  warps = warps < 1 ? 1 : (warps > most ? most : warps);
  return static_cast<unsigned int>(32 * warps);
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

// Launch on `stream` over the `size` entries of the offsets `at`, element i
// belonging to tree i % trees; sum, count (i64), ucb and lcb are row-major
// [trees, width]; each offset lies in [0, width). `mask` ([trees] bool) may be
// null: then every tree is solved. `threshold` is one float when `table` is
// 0, else a table of `table` floats indexed by the element's count. An offset
// repeated in one tree is solved twice from the same inputs and gets the same
// values. Returns the cudaError_t of the launch.
extern "C" int kl_bounds_pair_launch(const float* sum, const long long* count,
                                     const long long* at, const bool* mask,
                                     const float* threshold, long long table, float* ucb,
                                     float* lcb, long long trees, long long width,
                                     long long size, int iters, float eps, void* stream) {
  if (size <= 0) return 0;
  const unsigned int threads = pair_threads(size);
  long long blocks = (size + threads - 1) / threads;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  kl_bounds_pair_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sum, count, at, mask, threshold, table, ucb, lcb, trees, width, size, iters, eps);
  return static_cast<int>(cudaGetLastError());
}
