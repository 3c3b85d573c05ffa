// The constrained-KL expectation of the chance backups,
//   max_p E_p[f]  s.t.  KL(q || p) <= c,
// one problem a thread: utils/math.py::max_expectation_under_constraint on
// float32 [P, n] rows, the bits of its plain version _max_expectation as
// PyTorch runs that on the card.
//
// It replaces no TPU kernel: the JAX package (rl_agents_tpu/utils/math.py)
// leaves this solve to XLA. It was added because the port's plain version is
// some 50 small PyTorch kernels a Newton trip, run over the whole batch for as
// many trips as its slowest problem needs (MDP-GapE's chance backups solve
// [2 x 4096, 2] problems 105 times a plan, and some problems of most solves
// run all 100 trips), where a problem's work is a few dozen flops a trip.
//
// What bounds it: at the MDP-GapE cell's [8192, 2] a launch reads f, q and c
// and writes p, about 229 KB, some 0.07 us at 3.35 TB/s; in practice the
// dependent chain of logf and IEEE divisions of the longest problem's at
// most 100 Newton trips, some 10-20 us. What the design does about it: one
// thread a problem, its n atoms loaded once into registers, every case and
// every trip there, and each thread leaves its Newton loop when its problem
// converges, so that a warp pays for its slowest lane and not the batch for
// its slowest problem. The plain version's masked trips give the same bits as
// this exit: a converged problem's x and x_next never change again.
//
// Bits. Every operation is the plain version's float32 operation, in its
// order: each torch.where's chosen branch, the clamps at 1e-12 and 0 (NaN
// kept, as torch.clamp keeps it), logf, expf and IEEE division (built without
// --use_fast_math), no contraction into FMA (--fmad=false), the Python
// scalars rounded to float as PyTorch rounds them (1 - 0.9 in double, then
// float), isclose's atol + |rtol * b|, and the order in which PyTorch's CUDA
// reduction (ATen/native/cuda/Reduce.cuh) adds or compares a row's n atoms:
// for n < 32, last_pow2(n) lanes of a row, lane t holding atoms t and
// t + last_pow2(n) in two of its four accumulators (each started at the
// identity, then combined in order), the lanes then folded by warp shuffles at
// offsets halving from last_pow2(n) / 2 to 1. The wrapper takes the atom
// counts that the card tests hold bit for bit against the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;  // 128 blocks at the cell's 8192 problems, on 132 SMs
constexpr long long kMaxBlocks = 1LL << 20;  // the grid-stride loop covers the rest
constexpr int kMinAtoms = 2;
constexpr int kMaxAtoms = 16;
// torch.isclose's defaults, as float32 scalars
constexpr float kRtol = 1e-05f;
constexpr float kAtol = 1e-08f;

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.maximum / torch.minimum: NaN in either operand wins
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

struct Sum {  // torch.sum's combine, identity 0
  static constexpr float kIdentity = 0.f;
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

struct Max {  // torch.amax's combine (NaN propagates), identity -inf
  static constexpr float kIdentity = -INFINITY;
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (isnan(a) || a > b) ? a : b;
  }
};

__host__ __device__ constexpr int last_pow2(int n) {
  return (n & (n - 1)) == 0 ? n : last_pow2(n & (n - 1));
}

// A row of N atoms reduced in the order of PyTorch's CUDA reduction of the
// last axis of a contiguous [P, N] tensor (see the note at the top).
template <int N, typename Op>
__device__ __forceinline__ float reduce(const float (&x)[N], Op op) {
  constexpr int kLanes = last_pow2(N);
  static_assert(N < 32 && N < 2 * kLanes, "each lane holds at most two atoms");
  float lane[kLanes];
#pragma unroll
  for (int t = 0; t < kLanes; ++t) {
    float first = op(Op::kIdentity, x[t]);
    float second = (t + kLanes < N) ? op(Op::kIdentity, x[t + kLanes]) : Op::kIdentity;
    // four accumulators combined in order; the last two hold the identity
    lane[t] = op(op(op(first, second), Op::kIdentity), Op::kIdentity);
  }
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset /= 2) {
#pragma unroll
    for (int t = 0; t < offset; ++t) lane[t] = op(lane[t], lane[t + offset]);
  }
  return lane[0];
}

// theta(lam) and its slope d_theta(lam) (utils/math.py::_max_expectation),
// which share safe_diff(lam) and q_p / safe.
template <int N>
__device__ __forceinline__ void theta_and_slope(float lam, const float (&f)[N],
                                                const float (&q_p)[N], const bool (&plus)[N],
                                                float c, float* theta, float* slope) {
  float logs[N], inv[N], inv2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float safe = clamp_min(plus[i] ? lam - f[i] : 1.f, 1e-12f);
    logs[i] = plus[i] ? q_p[i] * logf(safe) : 0.f;
    inv[i] = plus[i] ? q_p[i] / safe : 0.f;
    inv2[i] = inv[i] / safe;
  }
  const float s = reduce(inv, Sum());
  *theta = (reduce(logs, Sum()) + logf(clamp_min(s, 0.f))) - c;
  *slope = s - reduce(inv2, Sum()) / clamp_min(s, 0.f);
}

template <int N>
__device__ __forceinline__ void solve(const float (&f)[N], float (&q)[N], float c, float eps,
                                      int max_iterations, float weight, float keep,
                                      float (&p)[N]) {
  bool all_zero = true;
#pragma unroll
  for (int i = 0; i < N; ++i) all_zero = all_zero && (q[i] == 0.f);
  bool plus[N];
  float q_p[N], f_plus[N], f_zero[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (all_zero) q[i] = 1.f / static_cast<float>(N);
    plus[i] = q[i] > 0.f;
    q_p[i] = plus[i] ? q[i] : 0.f;
    f_plus[i] = plus[i] ? f[i] : -INFINITY;
    f_zero[i] = plus[i] ? -INFINITY : f[i];
  }
  const float f_star = reduce(f, Max());
  const float f_p_max = reduce(f_plus, Max());

  // Case A: the maximum of f only on zero-mass atoms, where moving mass z
  // saturates the constraint at lambda = f_star.
  float theta_star, unused;
  theta_and_slope(f_star, f, q_p, plus, c, &theta_star, &unused);
  const bool case_a = (f_star > f_p_max) && (theta_star < 0.f);
  const float z = case_a ? 1.f - expf(theta_star) : 0.f;
  const float f_zero_max = reduce(f_zero, Max());
  int zero_max_count = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) zero_max_count += (!plus[i] && f[i] == f_zero_max);
  const float zero_share = z / fmaxf(static_cast<float>(zero_max_count), 1.f);

  // Case B: f constant (isclose) on the support, p = q.
  int first = 0;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) first = plus[i] ? i : first;
  float f_p0 = f[0];
#pragma unroll
  for (int i = 1; i < N; ++i) f_p0 = (i == first) ? f[i] : f_p0;
  const float allowed = fabsf(kRtol * f_p0) + kAtol;
  bool constant_f = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float error = fabsf(f[i] - f_p0);
    const bool close = (f[i] == f_p0) || (isfinite(error) && error <= allowed);
    constant_f = constant_f && (!plus[i] || close);
  }
  if (constant_f && !case_a) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = q[i];
    return;
  }

  // Otherwise theta(lambda) = 0 for lambda in [f_star, inf), by guarded
  // Newton steps from f_star + 1 (utils/math.py::newton_iteration), each step
  // that falls below f_star pulled back with the weight 0.9; above there is
  // no bound to cross.
  float lam = f_star;
  if (!case_a) {
    const float a = f_star;
    float x_next = f_star + 1.f;
    float x = INFINITY;
    for (int trip = 0; trip < max_iterations && fabsf(x - x_next) > eps; ++trip) {
      float theta, slope;
      theta_and_slope(x_next, f, q_p, plus, c, &theta, &slope);
      float step = (slope != 0.f) ? x_next - theta / slope : x_next;
      step = isfinite(step) ? step : x_next;
      if (step < a) step = weight * a + keep * x_next;
      x = x_next;
      x_next = step;
    }
    // clipped to [a, b], and a where the interval is a point (a == b == inf)
    lam = (a == INFINITY) ? a : minimum(maximum(x_next, a), INFINITY);
  }

  float safe[N], inv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    safe[i] = clamp_min(plus[i] ? lam - f[i] : 1.f, 1e-12f);
    inv[i] = plus[i] ? q_p[i] / safe[i] : 0.f;
  }
  const float rest = 1.f - z;
  const float beta = rest / clamp_min(reduce(inv, Sum()), 0.f);
  // beta <= 0: 1 - z shared by the support's atoms of largest f
  int top_count = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) top_count += (plus[i] && f[i] == f_star);
  const float top_share = rest / fmaxf(static_cast<float>(top_count), 1.f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p_plus = (beta <= 0.f) ? ((plus[i] && f[i] == f_star) ? top_share : 0.f)
                                       : (plus[i] ? (beta * q_p[i]) / safe[i] : 0.f);
    const float p_zero = (case_a && !plus[i] && f[i] == f_zero_max) ? zero_share : 0.f;
    p[i] = p_plus + p_zero;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
max_expectation_kernel(const float* __restrict__ f, const float* __restrict__ q,
                       const float* __restrict__ c, float* __restrict__ p, long long problems,
                       float eps, int max_iterations, float weight, float keep) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < problems; row += stride) {
    float f_row[N], q_row[N], p_row[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f_row[i] = f[row * N + i];
      q_row[i] = q[row * N + i];
    }
    solve<N>(f_row, q_row, c[row], eps, max_iterations, weight, keep, p_row);
#pragma unroll
    for (int i = 0; i < N; ++i) p[row * N + i] = p_row[i];
  }
}

template <int N>
cudaError_t launch_atoms(int atoms, unsigned int blocks, cudaStream_t stream, const float* f,
                         const float* q, const float* c, float* p, long long problems, float eps,
                         int max_iterations, float weight, float keep) {
  if constexpr (N > kMaxAtoms) {
    return cudaErrorInvalidValue;
  } else {
    if (atoms != N) {
      return launch_atoms<N + 1>(atoms, blocks, stream, f, q, c, p, problems, eps,
                                 max_iterations, weight, keep);
    }
    max_expectation_kernel<N><<<blocks, kThreads, 0, stream>>>(f, q, c, p, problems, eps,
                                                               max_iterations, weight, keep);
    return cudaGetLastError();
  }
}

}  // namespace

// Launch on `stream` over `problems` contiguous rows of `atoms` float32 atoms
// (f, q and p row-major [problems, atoms], c [problems]), `atoms` in [2, 16];
// `weight` is the out-of-bounds weight 0.9 and `keep` 1 - 0.9 taken in double
// and rounded to float. Allocates nothing and never synchronises. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int max_expectation_launch(const float* f, const float* q, const float* c, float* p,
                                      long long problems, int atoms, float eps,
                                      int max_iterations, float weight, float keep,
                                      void* stream) {
  if (atoms < kMinAtoms || atoms > kMaxAtoms) return static_cast<int>(cudaErrorInvalidValue);
  if (problems <= 0) return 0;
  long long blocks = (problems + kThreads - 1) / kThreads;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  return static_cast<int>(launch_atoms<kMinAtoms>(
      atoms, static_cast<unsigned int>(blocks), static_cast<cudaStream_t>(stream), f, q, c, p,
      problems, eps, max_iterations, weight, keep));
}
