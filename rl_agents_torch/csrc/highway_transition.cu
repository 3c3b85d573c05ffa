// The meta-action, single-ego highway transition in one launch: the whole of
// rl_agents_torch/envs/highway.py::HighwayEnv._transition_eager for
// action_type "meta" and one controlled vehicle, on float32 scenes.
//
// Replaces no TPU kernel. The JAX package writes this transition as array
// code (rl_agents_tpu/envs/highway.py) and XLA fuses it; the port's eager
// body launches about 314 small PyTorch kernels a call (which
// envs/base.py::TransitionGraphs replays from one CUDA graph), each reading
// and writing [B, V] or [3B, V, V] tensors through device memory. Here a
// scene never leaves the SM.
//
// What bounds it: nothing the card is short of. A call at 4096 rows of 15
// vehicles moves 2.77 MB and runs about 68 M operations
// (perfbench/counts/highway.py): about 1 us of either at the card's peaks.
// What it costs is latency: one pass over the inputs, three barriers, and a
// thread's own chain of six neighbour scans, nine IDM evaluations (each with
// float64 products) and MOBIL's choice. On an H100 a launch takes 0.016 ms
// at 4096 rows (6.4% of that bound) and 0.052 ms at 20,480 rows (9.7%),
// against 0.86 and 2.23 ms for the eager body's kernels.
//
// What the design does about it: one thread per (scene, vehicle). A scene of
// V <= 16 vehicles takes 16 lanes of a warp, one of V <= 32 a whole warp; a
// block of 128 threads holds 8 or 4 scenes, so 4096 scenes of 15 fill 512
// blocks over the 132 SMs. Each scene's x, lane, speed and alive flag are
// staged in shared memory; each thread then runs its six neighbour queries
// (ahead of and behind it, in its lane and the two candidate lanes) in one
// loop over the scene's vehicles, keeping each query's least gap, the number
// of vehicles at it and their speeds' sum in registers. A barrier lets every
// thread see the others' lane-change decisions and targets for the rear-mover
// suppression; another lets the ego's thread see the others' new x and lane
// for the collision test. The ego's thread then writes the scene's speed
// level, step count, reward, flags and info entries.
//
// The same bits as the eager body on the card. Built with --fmad=false and no
// fast math, so every float32 product, sum, IEEE division and sqrtf rounds on
// its own, as PyTorch's one-operation kernels do. Each utils/math.py::fma /
// fnma site is a float64 product and sum and then one cast to float32, as
// the eager's float64 addcmul and .to(float32) round it; fmaf would round
// once and miss. The operations run in the eager's
// order. The least gap is order-free; the sum of the speeds of the vehicles
// tied at it is exact for one or two (x + 0 == x, x + y == y + x). Three or
// more ties take the order of PyTorch's row reduction, at::native::
// reduce_kernel for a contiguous row of V floats (ATen/native/cuda/
// Reduce.cuh of PyTorch 2.11, its CUDA branch): W = last_pow2(V) lanes, lane
// t summing elements t and t + W, then a warp tree with offsets W/2, W/4,
// ..., 1 (`tie_sum`). The card tests hold ties of three and more.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVehicles = 32;

// highway-env's meta-actions (envs/highway.py)
constexpr long long kLaneLeft = 0;
constexpr long long kLaneRight = 2;
constexpr long long kFaster = 3;
constexpr long long kSlower = 4;

constexpr float kVehicleLength = 5.0f;
constexpr float kMinSpeed = 0.0f;
constexpr float kMaxSpeed = 40.0f;

// The params fields the transition reads, in this order; each is one value
// (or a vector of `width`) for every row, or one a row when bit k of
// `per_row` is set.
enum Field {
  kDt, kTargetSpeeds, kIdmT0, kIdmA, kIdmB, kIdmS0, kSpeedRewardRange,
  kCollisionReward, kRightLaneReward, kHighSpeedReward, kPoliteness, kMinGain,
  kBSafe, kFields
};

struct Inputs {
  const float* x;               // [B, V]
  const float* lane;            // [B, V]
  const long long* target_lane; // [B, V]
  const float* speed;           // [B, V]
  const long long* speed_level; // [B]
  const bool* alive;            // [B, V]
  const bool* crashed;          // [B]
  const long long* t;           // [B]
  const long long* action;      // [B]
};

struct Params {
  const float* field[kFields];
  unsigned per_row;
};

struct Outputs {
  float* vehicles;          // [3, B, V]: x, lane, speed
  long long* target_lane;   // [B, V]
  long long* counts;        // [2, B]: speed level, t
  float* floats;            // [4, B]: reward, the ego's unfrozen speed, cost, observation
  bool* flags;              // [2, B]: crashed, truncated
};

struct Shape {
  long long rows;
  int vehicles;
  int lanes;
  int slot;                 // lanes of the block a scene takes: 16 or 32
  long long max_steps;
  float inv_v0;             // recip(TRAFFIC_SPEED)
  float lane_weight;        // recip(max(lanes - 1, 1))
};

__device__ __forceinline__ float param(const Params& p, int k, long long row, int width = 1,
                                       int col = 0) {
  return p.field[k][((p.per_row >> k) & 1u) ? row * width + col : col];
}

// utils/math.py::fma and fnma: the float64 product is exact, the sum rounds
// in float64, then the cast to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

__device__ __forceinline__ float fnma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(c) -
                            static_cast<double>(a) * static_cast<double>(b));
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Idm {
  float s0, t0, a, neg_b, denominator, inv_v0;
};

// HighwayEnv._idm_from_leader with fused_interaction
__device__ float idm_from_leader(const Idm& m, float speed, bool has_leader, float gap,
                                 float leader_speed) {
  const float d = fminf((has_leader ? gap : 1e4f) - kVehicleLength, 1e4f);
  const float dv = speed - leader_speed;
  const float s_star = fma64(speed, m.t0, m.s0) + speed * dv / m.denominator;
  const float ratio = fmaxf(s_star, 0.0f) / fmaxf(d, 1.0f);
  const float free = speed * m.inv_v0;
  const float free2 = free * free;
  const float free_term = fnma64(free2, free2, 1.0f);
  const float interaction = fnma64(ratio, ratio, free_term);
  return fminf(fmaxf(m.a * (has_leader ? interaction : free_term), m.neg_b), m.a);
}

// One neighbour query's result: the least gap (inf: none), how many vehicles
// lie at it and, for up to two, their speeds' sum.
struct Nearest {
  float gap;
  int count;
  float sum;
};

__device__ __forceinline__ void offer(Nearest& q, float gap, float speed) {
  if (gap < q.gap) {
    q.gap = gap;
    q.count = 1;
    q.sum = speed;
  } else if (gap == q.gap) {
    q.sum = ++q.count == 2 ? q.sum + speed : q.sum;
  }
}

// The speeds' sum of query (own, ahead) of vehicle i over its tied nearest
// vehicles, in the order of PyTorch's sum over the last dim of the eager's
// where(near, speed, 0.0) row (see the note at the top).
__device__ __noinline__ float tie_sum(const float* sx, const float* slane,
                                      const float* sspeed, const bool* salive, int vehicles,
                                      int i, float own, bool ahead, float gap_min) {
  float term[kMaxVehicles];
  for (int j = 0; j < vehicles; ++j) {
    const float xi = sx[i], xj = sx[j];
    const bool mask = (ahead ? xj > xi : xj < xi) && fabsf(slane[j] - own) < 0.5f &&
                      salive[j] && salive[i];
    const float gap = ahead ? xj - xi : xi - xj;
    term[j] = mask && gap <= gap_min ? sspeed[j] : 0.0f;
  }
  int width = 1;
  while (2 * width <= vehicles) width *= 2;
  float lane_value[kMaxVehicles];
  for (int t = 0; t < width; ++t) {
    const float first = 0.0f + term[t];
    const float second = t + width < vehicles ? 0.0f + term[t + width] : 0.0f;
    lane_value[t] = ((first + second) + 0.0f) + 0.0f;
  }
  for (int offset = width / 2; offset > 0; offset /= 2)
    for (int t = 0; t < offset; ++t) lane_value[t] = lane_value[t] + lane_value[t + offset];
  return lane_value[0];
}

__global__ void __launch_bounds__(kThreads)
highway_transition_kernel(Inputs in, Params p, Outputs out, Shape s) {
  __shared__ float sx[kThreads], slane[kThreads], sspeed[kThreads];
  __shared__ bool salive[kThreads], schange[kThreads];
  __shared__ long long starget[kThreads];
  __shared__ float snew_x[kThreads], snew_lane[kThreads];

  const int tid = threadIdx.x;
  const int i = tid % s.slot;
  const int base = tid - i;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / s.slot) + tid / s.slot;
  const int V = s.vehicles;
  const bool active = row < s.rows && i < V;
  const long long e = row * V + i;
  const long long BV = s.rows * V;

  float xi = 0.0f, li = 0.0f, vi = 0.0f;
  bool ai = false;
  if (active) {
    xi = in.x[e];
    li = in.lane[e];
    vi = in.speed[e];
    ai = in.alive[e];
  }
  sx[tid] = xi;
  slane[tid] = li;
  sspeed[tid] = vi;
  salive[tid] = ai;
  __syncthreads();

  Idm m{};
  float dt = 0.0f, idm_b = 0.0f, acc_here = 0.0f, desired_gap = 0.0f;
  long long target1 = 0, level = 0;
  int delta = 0;
  bool change = false;
  if (active) {
    dt = param(p, kDt, row);
    m.s0 = param(p, kIdmS0, row);
    m.t0 = param(p, kIdmT0, row);
    m.a = param(p, kIdmA, row);
    idm_b = param(p, kIdmB, row);
    m.neg_b = -idm_b;
    m.denominator = 2.0f * sqrtf(m.a * idm_b);
    m.inv_v0 = s.inv_v0;

    // the ego's meta-action: speed level and target lane
    long long lane_delta = 0;
    if (i == 0) {
      const long long act = in.action[row];
      level = clamp_ll(in.speed_level[row] + (act == kFaster) - (act == kSlower), 0, 2);
      lane_delta = (act == kLaneLeft ? -1 : 0) + (act == kLaneRight ? 1 : 0);
    }
    target1 = clamp_ll(in.target_lane[e] + lane_delta, 0, s.lanes - 1);

    // _neighbor_stats for the current lane (k = 0) and the candidates
    // lane - 1 (k = 1) and lane + 1 (k = 2): leaders q = 2k, followers 2k + 1
    const float own[3] = {li, li - 1.0f, li + 1.0f};
    Nearest q[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = Nearest{CUDART_INF_F, 0, 0.0f};
    for (int j = 0; j < V; ++j) {
      const float xj = sx[base + j];
      if (!(salive[base + j] && ai) || xj == xi) continue;
      const bool ahead = xj > xi;
      const float gap = ahead ? xj - xi : xi - xj;
      const float lj = slane[base + j], vj = sspeed[base + j];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (fabsf(lj - own[k]) < 0.5f) {
          if (ahead) offer(q[2 * k], gap, vj);
          else offer(q[2 * k + 1], gap, vj);
        }
    }
    float nb_speed[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float sum = q[k].count < 3 ? q[k].sum
                        : tie_sum(sx + base, slane + base, sspeed + base, salive + base, V, i,
                                  own[k / 2], k % 2 == 0, q[k].gap);
      nb_speed[k] = sum / static_cast<float>(q[k].count > 1 ? q[k].count : 1);
    }

    // _mobil_target_lanes: own acceleration behind the (new) leader, the
    // (new) follower behind us, and that follower behind our (new) leader
    float acc[3], behind_us[3], behind_leader[3];
    bool has_f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Nearest& lead = q[2 * k];
      const Nearest& follow = q[2 * k + 1];
      const bool has_l = isfinite(lead.gap);
      has_f[k] = isfinite(follow.gap);
      acc[k] = idm_from_leader(m, vi, has_l, lead.gap, nb_speed[2 * k]);
      behind_us[k] = idm_from_leader(m, nb_speed[2 * k + 1], has_f[k], follow.gap, vi);
      behind_leader[k] = idm_from_leader(m, nb_speed[2 * k + 1], has_f[k] && has_l,
                                         follow.gap + lead.gap, nb_speed[2 * k]);
    }
    acc_here = acc[0];
    const float old_follower_gain = has_f[0] ? behind_leader[0] - behind_us[0] : 0.0f;
    const float politeness = param(p, kPoliteness, row);
    const float min_gain = param(p, kMinGain, row);
    const float b_safe = param(p, kBSafe, row);
    const float lane_hi = static_cast<float>(s.lanes - 0.75);
    bool ok[3];
    float gain[3];
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      const bool valid = own[k] >= -0.25f && own[k] <= lane_hi;
      const bool safe = !has_f[k] || behind_us[k] >= -b_safe;
      const float new_follower_gain = has_f[k] ? behind_us[k] - behind_leader[k] : 0.0f;
      gain[k] = acc[k] - acc_here + politeness * (new_follower_gain + old_follower_gain);
      ok[k] = valid && safe && gain[k] > min_gain;
    }
    const bool left_wins = ok[1] && (!ok[2] || gain[1] >= gain[2]);
    delta = (left_wins ? -1 : 0) + (ok[2] && !left_wins ? 1 : 0);
    const bool settled = fabsf(li - static_cast<float>(target1)) < 0.05f;
    change = settled && i >= 1 && ai && delta != 0;
    // VEHICLE_LENGTH + idm_s0 + speed * idm_t0
    desired_gap = fma64(vi, m.t0, kVehicleLength + m.s0);
  }
  schange[tid] = change;
  starget[tid] = target1 + (change ? delta : 0);
  __syncthreads();

  float new_x = 0.0f, new_lane = 0.0f, new_speed = 0.0f;
  long long new_target = 0;
  if (active) {
    // suppress the rear mover of any pair entering the same lane inside the
    // rear's desired gap
    bool suppressed = false;
    if (change) {
      const long long tgt = starget[tid];
      for (int j = 0; j < V; ++j) {
        if (j == i || !schange[base + j] || starget[base + j] != tgt) continue;
        const float xj = sx[base + j];
        const bool i_is_rear = xj > xi || (xj == xi && j < i);
        if (i_is_rear && fabsf(xj - xi) < desired_gap) suppressed = true;
      }
    }
    new_target = clamp_ll(target1 + (change && !suppressed ? delta : 0), 0, s.lanes - 1);

    float a;
    if (i == 0) {  // the ego tracks its target speed
      const float target_speed = param(p, kTargetSpeeds, row, 3, static_cast<int>(level));
      a = fminf(fmaxf(target_speed - vi, -idm_b), m.a);
    } else {
      a = acc_here;
    }
    new_speed = fminf(fmaxf(fma64(a, dt, vi), kMinSpeed), kMaxSpeed);
    new_x = fma64(new_speed, dt, xi);
    new_lane = li + fminf(fmaxf(static_cast<float>(new_target) - li, -dt), dt);
  }
  snew_x[tid] = new_x;
  snew_lane[tid] = new_lane;
  __syncthreads();
  if (!active) return;

  const bool frozen = in.crashed[row];
  out.vehicles[e] = frozen ? xi : new_x;
  out.vehicles[BV + e] = frozen ? li : new_lane;
  out.vehicles[2 * BV + e] = frozen ? vi : new_speed;
  out.target_lane[e] = new_target;
  if (i != 0) return;

  bool crash = frozen;
  for (int j = 1; j < V; ++j)
    crash = crash || (fabsf(snew_x[base + j] - new_x) < kVehicleLength &&
                      fabsf(snew_lane[base + j] - new_lane) < 0.8f && salive[base + j] && ai);

  const float lo = param(p, kSpeedRewardRange, row, 2, 0);
  const float hi = param(p, kSpeedRewardRange, row, 2, 1);
  const float cr = param(p, kCollisionReward, row);
  const float rl = param(p, kRightLaneReward, row);
  const float hs = param(p, kHighSpeedReward, row);
  const float scaled_speed = fminf(fmaxf((new_speed - lo) / (hi - lo), 0.0f), 1.0f);
  const float raw = fma64(new_lane, rl * s.lane_weight,
                          fma64(hs, scaled_speed, cr * (crash ? 1.0f : 0.0f)));
  const float reward = (raw - cr) / (hs + rl - cr);

  const long long R = s.rows;
  const long long t1 = in.t[row] + 1;
  out.counts[row] = level;
  out.counts[R + row] = t1;
  out.floats[row] = frozen ? 0.0f : fminf(fmaxf(reward, 0.0f), 1.0f);
  out.floats[R + row] = new_speed;
  out.floats[2 * R + row] = crash ? 1.0f : 0.0f;
  out.floats[3 * R + row] = 0.0f;
  out.flags[row] = crash;
  out.flags[R + row] = t1 >= s.max_steps;
}

}  // namespace

// Launch on `stream` over `rows` scenes of `vehicles` (1 to 32) vehicles on
// `lanes` lanes. The inputs are the HighwayState fields, contiguous and
// row-major, and the [rows] int64 actions; `fields` are the kFields params
// pointers in the Field order, each one value (or vector) for all rows or,
// where bit k of `per_row` is set, one a row. `out` is one buffer that holds
// the row-major outputs that Outputs describes, one after the other: the
// int64 target lanes and counts, then the float32 vehicles and floats, then
// the bool flags. Returns the cudaError_t of the launch.
extern "C" int highway_transition_launch(
    const float* x, const float* lane, const long long* target_lane, const float* speed,
    const long long* speed_level, const bool* alive, const bool* crashed, const long long* t,
    const long long* action, const float* dt, const float* target_speeds, const float* idm_t0,
    const float* idm_a, const float* idm_b, const float* idm_s0,
    const float* speed_reward_range, const float* collision_reward,
    const float* right_lane_reward, const float* high_speed_reward,
    const float* mobil_politeness, const float* mobil_min_gain, const float* mobil_b_safe,
    unsigned per_row, void* out, long long rows, int vehicles, int lanes, long long max_steps,
    float inv_v0, float lane_weight, void* stream) {
  if (rows <= 0) return 0;
  if (vehicles < 1 || vehicles > kMaxVehicles) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{x, lane, target_lane, speed, speed_level, alive, crashed, t, action};
  const Params p{{dt, target_speeds, idm_t0, idm_a, idm_b, idm_s0, speed_reward_range,
                  collision_reward, right_lane_reward, high_speed_reward, mobil_politeness,
                  mobil_min_gain, mobil_b_safe},
                 per_row};
  long long* const target_lane_out = static_cast<long long*>(out);
  long long* const counts_out = target_lane_out + rows * vehicles;
  float* const vehicles_out = reinterpret_cast<float*>(counts_out + 2 * rows);
  float* const floats_out = vehicles_out + 3 * rows * vehicles;
  bool* const flags_out = reinterpret_cast<bool*>(floats_out + 4 * rows);
  const Outputs outputs{vehicles_out, target_lane_out, counts_out, floats_out, flags_out};
  const int slot = vehicles <= 16 ? 16 : 32;
  const Shape shape{rows, vehicles, lanes, slot, max_steps, inv_v0, lane_weight};
  const long long scenes_per_block = kThreads / slot;
  const long long blocks = (rows + scenes_per_block - 1) / scenes_per_block;
  highway_transition_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(in, p, outputs, shape);
  return static_cast<int>(cudaGetLastError());
}
