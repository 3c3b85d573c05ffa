"""Functional highway driving environments (highway-env surrogates), batch-first.

Port of ``rl_agents_tpu/envs/highway.py``: the surrogates of highway-env's
``highway-v0``, ``merge-v0``, ``exit-v0``, ``roundabout-v0``,
``intersection-v0`` and ``two-way-v0`` with the same observation, action and
reward interfaces.

* vehicles: ego + V-1 traffic on L lanes; traffic follows IDM longitudinal
  dynamics and MOBIL lane changes (safety and incentive criteria, politeness
  factor); the ego executes highway-env's discrete meta-actions
  [LANE_LEFT, IDLE, LANE_RIGHT, FASTER, SLOWER];
* observation: Kinematics rows [presence, x, y, vx, vy] (ego first, the others
  relative to the ego and sorted by distance, normalized), or the
  TimeToCollision grid, the occupancy grid or the lidar;
* reward: highway-env's normalized combination of collision penalty,
  high-speed reward and right-lane reward.

Every state field carries a leading batch axis ``[B]``. The dynamics draw
nothing (``transition_uses_key = False``): ``step`` ignores its generator and
noise, and ``null_noise`` is None. Params fields may also carry a leading
row axis ``[B]`` (one model per row: the robust planner steps a model
ensemble as one batch).

The JAX package selects rows through one-hot masked sums (its TPU kernels
avoid per-lane gathers); here rows are indexed directly (a stable ``argsort``
and ``gather``), which selects the same values.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import (Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv,
                                       StepOut, TupleSpace)
from rl_agents_torch.ops import highway_transition as transition_kernel
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, fnma, recip

# meta-actions (highway-env order)
LANE_LEFT, IDLE, LANE_RIGHT, FASTER, SLOWER = 0, 1, 2, 3, 4

LANE_WIDTH = 4.0
VEHICLE_LENGTH = 5.0
MAX_SPEED = 40.0
MIN_SPEED = 0.0
TRAFFIC_SPEED = 25.0  # the traffic's IDM target speed
_INV_TRAFFIC_SPEED = recip(TRAFFIC_SPEED)  # _idm_terms' inv_v0 for the traffic
_TWO_PI = 2 * math.pi
# The counters of a transition that runs the eager body: its own, and the name
# under which the benchmark's ``env.transition_kernel_share.*`` reads those
# calls until that metric divides by ``env.transition_eager.calls``.
EAGER_COUNTERS = ("env.transition_eager.calls", "env.transition_graph.eager")


class HighwayParams(NamedTuple):
    dt: Any                 # [] policy step duration
    lanes: Any              # [] i64
    target_speeds: Any      # [3] ego cruise speed levels
    idm_t0: Any             # desired time gap
    idm_a: Any              # max acceleration
    idm_b: Any              # comfortable deceleration
    idm_s0: Any             # minimum gap
    speed_reward_range: Any  # [2]
    collision_reward: Any
    right_lane_reward: Any
    high_speed_reward: Any
    obs_scale: Any          # [4] normalization for (x, y, vx, vy)
    mobil_politeness: Any   # MOBIL politeness factor p (highway-env: 0.0)
    mobil_min_gain: Any     # MOBIL acceleration-gain threshold [m/s^2]
    mobil_b_safe: Any       # max braking imposed on the new follower [m/s^2]


# the fields that are vectors in one model's params
_VECTOR_FIELDS = ("target_speeds", "speed_reward_range", "obs_scale")


class _IDMTerms(NamedTuple):
    s0: Any            # idm_s0, shaped for [B, V]
    t0: Any            # idm_t0
    a: Any             # idm_a
    neg_b: Any         # -idm_b
    denominator: Any   # 2 sqrt(idm_a idm_b)
    inv_v0: float      # 1 / max(target speed, 1)
    one: Any           # 1.0


class HighwayState(NamedTuple):
    x: Any            # [B, V] f32 longitudinal positions
    lane: Any         # [B, V] f32 lateral lane position (continuous for changes)
    target_lane: Any  # [B, V] i64
    speed: Any        # [B, V] f32
    speed_level: Any  # [B] i64 ego target-speed index ([B, N] with N egos)
    alive: Any        # [B, V] bool
    crashed: Any      # [B] bool
    t: Any            # [B] i64


def _row(value, ndim: int):
    """A scalar param field, ``[]`` or one per row ``[B]``, shaped to
    broadcast against a ``[B, ...]`` tensor of ``ndim`` dimensions."""
    if value.dim() == 0:
        return value
    return value.reshape(value.shape[:1] + (1,) * (ndim - 1))


def _vec(value):
    """A vector param field, ``[K]`` or one per row ``[B, K]``, as ``[1 or B, K]``."""
    return value[None] if value.dim() == 1 else value


def _repeat_rows(params, k: int):
    """Params for ``k`` stacked copies of a batch: the fields that carry a row
    axis, repeated ``k`` times along it."""
    return params._replace(**{
        name: getattr(params, name).repeat((k,) + (1,) * (getattr(params, name).dim() - 1))
        for name in params._fields
        if getattr(params, name).dim() == (2 if name in _VECTOR_FIELDS else 1)})


def _pick(values, index):
    """``values [1 or B, K]`` at ``index [B]`` or ``[B, N]`` (exact selection)."""
    values = _vec(values)
    flat = index.reshape(index.shape[0], -1)
    picked = values.expand(flat.shape[0], -1).gather(1, flat)
    return picked.reshape(index.shape)


def _fma_scalar(a, b: float, c):
    """``fma(a, b, c)`` with ``b`` a float32 constant of the program held as
    a Python float (``c`` a tensor or such a constant), so that nothing is
    copied to the card: the float64 product is exact and the sum rounds
    once, then to float32, as ``fma`` rounds them."""
    return (a.double() * b + c).to(torch.float32)


def _col(values, k: int, ndim: int):
    """Column ``k`` of a vector param field, shaped as ``_row``."""
    values = _vec(values)[:, k]
    return values.reshape(values.shape[:1] + (1,) * (ndim - 1)) if values.shape[0] > 1 \
        else values.reshape(())


class HighwayEnv(FunctionalEnv):
    """Single- or multi-ego highway with configurable action and observation
    types (reference env variant configs:
    scripts/configs/HighwayEnv/env_multi_agent.json, env_continuous.json,
    env_obs_attention.json).

    * ``controlled_vehicles``: N egos at indices 0..N-1; the action is ``[B, N]``
      and the observation a tuple of N ego-centric kinematics tensors;
    * ``action_type``: "meta" (5 discrete meta-actions) or "continuous"
      (``[B, 2]`` = [acceleration, steering] in [-1, 1]);
    * ``obs_type``: "kinematics" (default), "ttc" (``[3, lanes, horizon]``),
      "occupancy_grid" (``[F, H, W]``) or "lidar" (``[cells, 2]``);
    * ``obs_features``: 5 = [presence, x, y, vx, vy]; 7 adds cos_h/sin_h.
    """

    transition_uses_key = False  # IDM dynamics are deterministic given actions

    def __init__(self, vehicles: int = 15, lanes: int = 4, max_episode_steps: int = 40,
                 policy_dt: float = 1.0, controlled_vehicles: int = 1,
                 action_type: str = "meta",
                 steering_range: tuple = (-0.7853981633974483, 0.7853981633974483),
                 acceleration_range: tuple = (-5.0, 5.0),
                 obs_type: str = "kinematics", obs_features: int = 5,
                 obs_vehicles: int | None = None, ttc_horizon: int = 10,
                 grid_shape: tuple = (11, 11), grid_step: tuple = (5.0, 5.0),
                 lidar_cells: int = 16, lidar_range: float = 64.0):
        if action_type not in ("meta", "continuous"):
            raise ValueError(f"Unknown action_type {action_type}")
        if obs_type not in ("kinematics", "ttc", "occupancy_grid", "lidar"):
            raise ValueError(f"Unknown obs_type {obs_type}")
        if not 1 <= controlled_vehicles <= vehicles:
            raise ValueError("controlled_vehicles must be in [1, vehicles]")
        self.vehicles = vehicles
        self.lanes = lanes
        self.max_episode_steps = max_episode_steps
        self.policy_dt = policy_dt
        self.controlled_vehicles = controlled_vehicles
        self.action_type = action_type
        self.steering_range = tuple(steering_range)
        self.acceleration_range = tuple(acceleration_range)
        self.obs_type = obs_type
        self.obs_features = obs_features
        self.obs_vehicles = obs_vehicles if obs_vehicles is not None else vehicles
        self.ttc_horizon = ttc_horizon
        self.grid_shape = tuple(grid_shape)
        self.grid_step = tuple(grid_step)
        self.lidar_cells = lidar_cells
        self.lidar_range = lidar_range
        self.spec = EnvSpec("highway", max_episode_steps)

    @property
    def action_space(self):
        if self.action_type == "continuous":
            return Box(-1.0, 1.0, (2,))
        if self.controlled_vehicles > 1:
            return TupleSpace((Discrete(5),) * self.controlled_vehicles)
        return Discrete(5)

    def _single_obs_space(self):
        if self.obs_type == "ttc":
            return Box(0.0, 1.0, (3, self.lanes, self.ttc_horizon))
        if self.obs_type == "occupancy_grid":
            return Box(-1.0, 1.0, (self.obs_features,) + self.grid_shape)
        if self.obs_type == "lidar":
            return Box(-1.0, 1.0, (self.lidar_cells, 2))
        return Box(-1.0, 1.0, (min(self.obs_vehicles, self.vehicles), self.obs_features))

    @property
    def observation_space(self):
        if self.controlled_vehicles > 1:
            return TupleSpace((self._single_obs_space(),) * self.controlled_vehicles)
        return self._single_obs_space()

    def default_params(self, device="cuda") -> HighwayParams:
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return HighwayParams(
            dt=f32(self.policy_dt),
            lanes=torch.tensor(self.lanes, dtype=torch.int64, device=device),
            target_speeds=f32([20.0, 25.0, 30.0]),
            idm_t0=f32(1.5), idm_a=f32(3.0), idm_b=f32(5.0), idm_s0=f32(10.0),
            speed_reward_range=f32([20.0, 30.0]),
            collision_reward=f32(-1.0),
            right_lane_reward=f32(0.1),
            high_speed_reward=f32(0.4),
            obs_scale=f32([100.0, 100.0, 20.0, 20.0]),
            # highway-env IDMVehicle defaults (behavior.py: POLITENESS=0,
            # LANE_CHANGE_MIN_ACC_GAIN=0.2, LANE_CHANGE_MAX_BRAKING_IMPOSED=2)
            mobil_politeness=f32(0.0), mobil_min_gain=f32(0.2), mobil_b_safe=f32(2.0))

    def _level0(self, batch: int, device):
        N = self.controlled_vehicles
        shape = (batch,) if N == 1 else (batch, N)
        return torch.ones(shape, dtype=torch.int64, device=device)

    def _new_state(self, x, lane, speed, level):
        B, V = x.shape
        device = x.device
        return HighwayState(
            x=x, lane=lane.to(torch.float32), target_lane=lane.to(torch.int64), speed=speed,
            speed_level=level, alive=torch.ones((B, V), dtype=torch.bool, device=device),
            crashed=torch.zeros(B, dtype=torch.bool, device=device),
            t=torch.zeros(B, dtype=torch.int64, device=device))

    # ------------------------------------------------------------------
    def reset(self, params: HighwayParams, generator: torch.Generator, batch: int = 1,
              noise=None):
        """``batch`` fresh states. ``noise`` injects the draws, ``(spacing,
        lane, speed)`` of shape ``[batch, V]`` each: uniforms in [0, 1), lane
        indices, uniforms; without it they come from ``generator``."""
        V, L, N = self.vehicles, self.lanes, self.controlled_vehicles
        device = params.dt.device
        if noise is None:
            gen_device = generator.device
            spacing_u = torch.rand((batch, V), generator=generator, device=gen_device)
            lane = torch.randint(0, L, (batch, V), generator=generator, device=gen_device)
            speed_u = torch.rand((batch, V), generator=generator, device=gen_device)
        else:
            spacing_u, lane, speed_u = noise
        # ego at x=0 on the leftmost lane index L-1; traffic ahead, ~25 m apart
        spacing = (25.0 + 5.0 * spacing_u).to(device)
        x = torch.cumsum(spacing, dim=1) - spacing[:, :1]
        lane = lane.to(device=device, dtype=torch.int64, copy=True)
        speed = (20.0 + 5.0 * speed_u).to(device)
        lane[:, 0] = L - 1
        # all egos start at cruise speed; extra egos keep their random lanes
        speed = torch.where(torch.arange(V, device=device) < N, 25.0, speed)
        state = self._new_state(x, lane, speed, self._level0(batch, device))
        return state, self.observe(params, state)

    # ------------------------------------------------------------------
    @staticmethod
    def _neighbor_stats(x, speed, own_lane, other_lane, alive, ahead_dir: bool):
        """Per-vehicle closest in-lane neighbour over ``[B, V(i), V(j)]`` pairs.
        ``own_lane[:, i]`` is the (possibly candidate) lane vehicle i is
        evaluated in; the others sit at their actual ``other_lane``. Returns
        (has_neighbor, gap_min, neighbor_speed), the gap center-to-center along
        x, toward the leader if ``ahead_dir`` else toward the follower."""
        xi, xj = x[:, :, None], x[:, None, :]
        same_lane = (other_lane[:, None, :] - own_lane[:, :, None]).abs() < 0.5
        pair_alive = alive[:, None, :] & alive[:, :, None]
        if ahead_dir:
            mask = (xj > xi) & same_lane & pair_alive
            gap = torch.where(mask, xj - xi, torch.inf)
        else:
            mask = (xj < xi) & same_lane & pair_alive
            gap = torch.where(mask, xi - xj, torch.inf)
        gap_min = gap.amin(dim=2)
        has = torch.isfinite(gap_min)
        near = mask & (gap <= gap_min[:, :, None])
        count = near.sum(dim=2).clamp(min=1)
        nb_speed = torch.where(near, speed[:, None, :], 0.0).sum(dim=2) / count
        return has, gap_min, nb_speed

    @staticmethod
    def _idm_terms(params, target_speed) -> _IDMTerms:
        """The IDM's per-model terms, taken once per transition and shaped
        for ``[B, V]`` operands. The target speed (a Python float) is a
        constant of the JAX package's program, so its division by it is a
        multiplication by the float32 reciprocal."""
        a, b = _row(params.idm_a, 2), _row(params.idm_b, 2)
        return _IDMTerms(s0=_row(params.idm_s0, 2), t0=_row(params.idm_t0, 2), a=a, neg_b=-b,
                         denominator=2 * torch.sqrt(a * b), inv_v0=recip(max(target_speed, 1.0)),
                         one=torch.ones((), device=a.device))

    @staticmethod
    def _idm_from_leader(idm: _IDMTerms, speed, has_leader, gap_min, leader_speed,
                         fused_interaction: bool = True):
        """IDM acceleration ``[B, V]`` given precomputed leader stats.
        ``fused_interaction`` says whether XLA fuses the subtraction of the
        interaction term into a multiply-add: it does in the highway
        transition; in the two-way one its vectorized loop body does not
        (and its scalar remainder loop does, so JAX's own two-way result
        for a tree depends on the batch size by an ulp)."""
        d = torch.clamp(torch.where(has_leader, gap_min, 1e4) - VEHICLE_LENGTH, max=1e4)
        dv = speed - leader_speed
        # idm_s0 + speed * idm_t0 is one fused multiply-add in the JAX package
        s_star = fma(speed, idm.t0, idm.s0) + speed * dv / idm.denominator
        ratio = torch.clamp(s_star, min=0.0) / torch.clamp(d, min=1.0)
        # ``** 2`` and ``** 4`` with an int exponent are repeated products in
        # JAX, and both subtractions of ``1 - (v / v0) ** 4 - interaction``
        # are fused multiply-adds
        free = speed * idm.inv_v0
        free2 = free * free
        free_term = fnma(free2, free2, idm.one)
        interaction = fnma(ratio, ratio, free_term) if fused_interaction \
            else free_term - ratio * ratio
        inner = torch.where(has_leader, interaction, free_term)
        return torch.minimum(torch.maximum(idm.a * inner, idm.neg_b), idm.a)

    def _idm_acceleration(self, params, state: HighwayState, target_speed):
        """IDM longitudinal model: follow the closest leader in-lane."""
        has, gap_min, lead_speed = self._neighbor_stats(
            state.x, state.speed, state.lane, state.lane, state.alive, True)
        return self._idm_from_leader(self._idm_terms(params, target_speed), state.speed, has,
                                     gap_min, lead_speed)

    def _mobil_target_lanes(self, params, state: HighwayState, target_lane, traffic_target_speed):
        """MOBIL lane-change decision for traffic (highway-env behavior.py
        IDMVehicle.mobil: safety criterion, the new follower's imposed braking
        stays under ``mobil_b_safe``, and incentive criterion, own IDM gain plus
        politeness-weighted follower gains exceeds ``mobil_min_gain``). Each
        vehicle's candidate move is evaluated against the others' current
        lanes; settled vehicles only, never an ego. Returns (new_target_lane,
        current-lane IDM acceleration)."""
        V, L = self.vehicles, self.lanes
        B = state.x.shape[0]
        x, speed, lane, alive = state.x, state.speed, state.lane, state.alive
        device = x.device
        ts = traffic_target_speed
        politeness = _row(params.mobil_politeness, 2)
        min_gain = _row(params.mobil_min_gain, 2)
        b_safe = _row(params.mobil_b_safe, 2)

        # The current lane and the two candidate lanes are evaluated as one
        # stacked batch [3 * B, V] (current, left, right): the same
        # elementwise program as three passes, a third of the launches.
        own = torch.cat([lane, lane - 1.0, lane + 1.0])
        x3, speed3, alive3, lane3 = (t.repeat(3, 1) for t in (x, speed, alive, lane))
        idm = self._idm_terms(_repeat_rows(params, 3), ts)
        has_l, gap_l, speed_l = self._neighbor_stats(x3, speed3, own, lane3, alive3, True)
        has_f, gap_f, speed_f = self._neighbor_stats(x3, speed3, own, lane3, alive3, False)
        # own acceleration behind the (new) leader
        acc = self._idm_from_leader(idm, speed3, has_l, gap_l, speed_l)
        # the (new) follower behind us
        behind_us = self._idm_from_leader(idm, speed_f, has_f, gap_f, speed3)
        # the (new) follower behind our (new) leader, at gap_f + gap_l: where the
        # old follower ends up when we leave, where the new one is before we come
        behind_leader = self._idm_from_leader(idm, speed_f, has_f & has_l, gap_f + gap_l,
                                              speed_l)
        acc_here = acc[:B]
        old_follower_gain = torch.where(has_f[:B], behind_leader[:B] - behind_us[:B], 0.0)

        def candidate(k):
            rows = slice(k * B, (k + 1) * B)
            cand = own[rows]
            valid = (cand >= -0.25) & (cand <= L - 0.75)
            nh_f, nf_after = has_f[rows], behind_us[rows]
            safe = ~nh_f | (nf_after >= -b_safe)
            new_follower_gain = torch.where(nh_f, nf_after - behind_leader[rows], 0.0)
            gain = acc[rows] - acc_here + politeness * (new_follower_gain + old_follower_gain)
            ok = valid & safe & (gain > min_gain)
            return ok, gain

        ok_left, gain_left = candidate(1)
        ok_right, gain_right = candidate(2)
        left_wins = ok_left & (~ok_right | (gain_left >= gain_right))
        delta = torch.where(left_wins, -1, 0) + torch.where(ok_right & ~left_wins, 1, 0)
        settled = (lane - target_lane.to(torch.float32)).abs() < 0.05
        idx = torch.arange(V, device=device)
        # every controlled vehicle's lateral moves are meta-actions, not MOBIL
        is_traffic = idx >= self.controlled_vehicles
        change = settled & is_traffic & alive & (delta != 0)
        # Concurrent movers: each candidate was evaluated against the others'
        # CURRENT lanes, so two simultaneous movers can target the same gap.
        # Suppress the REAR mover of any pair entering the same lane inside
        # the rear's desired IDM gap.
        tgt = target_lane + torch.where(change, delta, 0)
        pair = change[:, :, None] & change[:, None, :] & (idx[:, None] != idx[None, :])
        same_tgt = pair & (tgt[:, :, None] == tgt[:, None, :])
        xi, xj = x[:, :, None], x[:, None, :]
        i_is_rear = (xj > xi) | ((xj == xi) & (idx[None, :] < idx[:, None]))
        # VEHICLE_LENGTH + idm_s0 + speed * idm_t0: one fused multiply-add in JAX
        desired_gap = fma(speed, _row(params.idm_t0, 2), VEHICLE_LENGTH + _row(params.idm_s0, 2))
        dist = (xj - xi).abs()
        suppressed = (same_tgt & i_is_rear & (dist < desired_gap[:, :, None])).any(dim=2)
        change = change & ~suppressed
        new_target = torch.clamp(target_lane + torch.where(change, delta, 0), 0, L - 1)
        return new_target, acc_here

    def step(self, params: HighwayParams, state: HighwayState, action, generator=None,
             noise=None) -> StepOut:
        out = self.transition(params, state, action, generator, noise)
        return out._replace(obs=self.observe(params, out.state))

    def transition(self, params: HighwayParams, state: HighwayState, action, generator=None,
                   noise=None) -> StepOut:
        """Dynamics without the (sorted, normalized) observation: the
        open-loop planning hot path. ``action`` is ``[B]`` meta-actions,
        ``[B, N]`` with N egos, or ``[B, 2]`` continuous commands. The
        dynamics draw nothing: ``generator`` and ``noise`` are ignored. On
        the card, meta-actions of one ego run as one hand-written kernel
        (``ops/highway_transition.py``), the same bits; the forms that
        ``kernel_declines`` names (continuous actions, several egos, a
        transition of a subclass's own, grad into an input, CPU tensors) run
        the eager body, counted in ``EAGER_COUNTERS``."""
        del generator, noise
        action = torch.as_tensor(action, device=state.x.device)
        if self.kernel_declines(params, state, action) is None:
            return transition_kernel.launch(params, state, action, self.lanes,
                                            self.max_episode_steps, _INV_TRAFFIC_SPEED)
        counters.update(EAGER_COUNTERS)
        return self._transition_eager(params, state, action)

    # the dynamics draw nothing (``transition`` ignores its generator and noise):
    # a planner may capture them without injected env draws
    transition_draws = False

    def kernel_declines(self, params: HighwayParams, state: HighwayState, action):
        """Which form of call ``transition`` runs the eager body for, or None
        where it launches the kernel: the kernel computes ``HighwayEnv``'s own
        body for meta-actions of one ego on the card. A call of that form
        whose tensors the kernel cannot take (more than
        ``MAX_VEHICLES`` vehicles, another dtype or shape, a params form it
        does not read, tensors on several devices) is a wrong input and
        raises ``ValueError``."""
        if self.action_type != "meta":
            return "continuous actions"
        if self.controlled_vehicles != 1:
            return "several egos"
        if (type(self).transition is not HighwayEnv.transition
                or type(self)._transition_eager is not HighwayEnv._transition_eager):
            return "a transition of its own"
        if transition_kernel.wants_grad(params, state, action):
            return "grad into an input"
        if not state.x.is_cuda:
            return "CPU tensors"
        reason = transition_kernel.declines(params, state, action, self.vehicles)
        if reason is not None:
            raise ValueError(f"the highway transition kernel cannot take this call: {reason}")
        return None

    def _transition_eager(self, params: HighwayParams, state: HighwayState, action) -> StepOut:
        """The transition's operations, launched one by one."""
        V, L = self.vehicles, self.lanes
        N = self.controlled_vehicles
        B = state.x.shape[0]
        device = state.x.device
        frozen = state.crashed
        idx = torch.arange(V, device=device)
        is_ego = idx == 0 if N == 1 else idx < N
        idm_a, idm_b = _row(params.idm_a, 2), _row(params.idm_b, 2)
        dt2 = _row(params.dt, 2)
        lane_rate_ego = None

        if self.action_type == "continuous":
            # ContinuousAction (highway-env action.py:117-160): [acceleration,
            # steering] in [-1, 1]^2 mapped into the configured ranges
            speed_level = state.speed_level
            a_lo, a_hi = self.acceleration_range
            s_lo, s_hi = self.steering_range
            act = torch.clamp(torch.as_tensor(action, dtype=torch.float32, device=device)
                              .reshape(B, 2), -1.0, 1.0)
            # ``lo + (u + 1) * 0.5 * (hi - lo)``: XLA folds the two constant
            # factors into one and fuses the multiply-add
            def scaled(u, lo, hi):
                return _fma_scalar(u + 1.0, float(np.float32(0.5) * np.float32(hi - lo)),
                                   float(np.float32(lo)))

            ego_acc = scaled(act[:, 0], a_lo, a_hi)[:, None]
            steering = scaled(act[:, 1], s_lo, s_hi)
            lane_rate_ego = state.speed[:, 0] * torch.sin(steering) * recip(LANE_WIDTH)
            # traffic keeps MOBIL/IDM; the ego's target lane tracks its position
            target_lane, idm_acc = self._mobil_target_lanes(params, state, state.target_lane,
                                                            TRAFFIC_SPEED)
        else:
            acts = torch.as_tensor(action, dtype=torch.int64, device=device)
            acts = acts.reshape(B) if N == 1 else acts.reshape(B, N)
            speed_level = torch.clamp(state.speed_level + (acts == FASTER).to(torch.int64)
                                      - (acts == SLOWER).to(torch.int64), 0, 2)
            if N == 1:
                lane_delta = (torch.where(acts == LANE_LEFT, -1, 0)
                              + torch.where(acts == LANE_RIGHT, 1, 0))[:, None]
            else:
                acts_v = torch.cat([acts, torch.full((B, V - N), IDLE, dtype=torch.int64,
                                                     device=device)], dim=1)
                lane_delta = torch.where(acts_v == LANE_LEFT, -1, 0) \
                    + torch.where(acts_v == LANE_RIGHT, 1, 0)
            target_lane = torch.clamp(state.target_lane + torch.where(is_ego, lane_delta, 0),
                                      0, L - 1)
            # traffic MOBIL lane changes (egos excluded inside); its current-lane
            # leader pass gives the IDM acceleration below
            target_lane, idm_acc = self._mobil_target_lanes(params, state, target_lane,
                                                            TRAFFIC_SPEED)
            # egos track their target speed directly (collision avoidance is
            # the planner's job, as in highway-env's ControlledVehicle)
            if N == 1:
                ego_target = _pick(params.target_speeds, speed_level)[:, None]
                ego_acc = torch.minimum(torch.maximum(ego_target - state.speed[:, :1], -idm_b),
                                        idm_a)
            else:
                target_v = torch.cat([_pick(params.target_speeds, speed_level),
                                      torch.zeros((B, V - N), device=device)], dim=1)
                ego_acc = torch.minimum(torch.maximum(target_v - state.speed, -idm_b), idm_a)

        # --- longitudinal dynamics: traffic follows IDM ---------------
        acc = torch.where(is_ego, ego_acc, idm_acc)
        speed = torch.clamp(fma(acc, dt2, state.speed), MIN_SPEED, MAX_SPEED)
        x = fma(speed, dt2, state.x)

        # --- lateral dynamics: first-order pull to target lane --------
        lane = state.lane + torch.minimum(torch.maximum(
            target_lane.to(torch.float32) - state.lane, -dt2), dt2)
        if lane_rate_ego is not None:
            ego_lane = torch.clamp(fma(lane_rate_ego, params.dt.reshape(-1), state.lane[:, 0]),
                                   0.0, L - 1.0)
            lane = torch.where(idx == 0, ego_lane[:, None], lane)
            target_lane = torch.where(idx == 0, torch.round(ego_lane).to(torch.int64)[:, None],
                                      target_lane)

        # --- collisions ------------------------------------------------
        close_x = (x[:, None, :] - x[:, :, None]).abs() < VEHICLE_LENGTH
        close_lane = (lane[:, None, :] - lane[:, :, None]).abs() < 0.8
        both_alive = state.alive[:, None, :] & state.alive[:, :, None]
        not_self = idx[:, None] != idx[None, :]
        colliding = close_x & close_lane & both_alive & not_self
        if N == 1:
            ego_crash = colliding[:, 0].any(dim=1) | state.crashed
        else:
            per_ego_crash = colliding[:, :N].any(dim=2) | state.crashed[:, None]
            ego_crash = per_ego_crash.any(dim=1)

        # the JAX package's freeze blend ``old * fm + new * (1 - fm)`` with
        # fm in {0, 1} selects one of the two exactly
        keep = frozen[:, None]
        new_state = HighwayState(
            x=torch.where(keep, state.x, x), lane=torch.where(keep, state.lane, lane),
            target_lane=target_lane, speed=torch.where(keep, state.speed, speed),
            speed_level=speed_level, alive=state.alive, crashed=ego_crash, t=state.t + 1)

        # --- reward (highway-env normalized combination) --------------
        nd = 1 if N == 1 else 2
        lo, hi = _col(params.speed_reward_range, 0, nd), _col(params.speed_reward_range, 1, nd)
        cr = _row(params.collision_reward, nd)
        hs = _row(params.high_speed_reward, nd)
        rl = _row(params.right_lane_reward, nd)
        if N == 1:
            scaled_speed = torch.clamp((speed[:, 0] - lo) / (hi - lo), 0.0, 1.0)
            # XLA folds the constant 1 / (L - 1) into the lane weight
            raw = self._reward_sum(cr * ego_crash.to(torch.float32), hs, scaled_speed,
                                   rl * recip(max(L - 1, 1)), lane[:, 0])
        else:
            # the mean of the per-ego rewards (highway-env multi-agent)
            scaled_speed = torch.clamp((speed[:, :N] - lo) / (hi - lo), 0.0, 1.0)
            raw = self._reward_sum(cr * per_ego_crash.to(torch.float32), hs, scaled_speed,
                                   rl * recip(max(L - 1, 1)), lane[:, :N]).sum(dim=1)
        cr1, hs1, rl1 = (_row(p, 1) for p in (params.collision_reward,
                                              params.high_speed_reward,
                                              params.right_lane_reward))
        if N == 1:
            centered = raw - cr1
        else:  # the mean's ``sum / N`` and ``- collision_reward`` fuse into one FMA
            centered = _fma_scalar(raw, recip(N), -cr1)
        reward = centered / (hs1 + rl1 - cr1)
        reward = torch.where(frozen, 0.0, torch.clamp(reward, 0.0, 1.0))

        truncated = new_state.t >= self.max_episode_steps
        obs = torch.zeros((B, 1), device=device)  # no observation on the planning path
        return StepOut(new_state, obs, reward, ego_crash, truncated,
                       {"crashed": ego_crash, "speed": speed[:, 0],
                        "cost": ego_crash.to(torch.float32)})

    @staticmethod
    def _reward_sum(collision, hs, scaled_speed, lane_weight, lane):
        """``collision + hs * scaled_speed + lane_weight * lane``, each product
        fused into the sum as the JAX package's XLA program does."""
        return fma(lane, lane_weight, fma(hs, scaled_speed, collision))

    # ------------------------------------------------------------------
    def observe(self, params: HighwayParams, state: HighwayState):
        if self.controlled_vehicles > 1:
            return tuple(self._observe_single(params, state, e)
                         for e in range(self.controlled_vehicles))
        return self._observe_single(params, state, 0)

    def _observe_single(self, params: HighwayParams, state: HighwayState, ego: int):
        if self.obs_type == "ttc":
            return self._observe_ttc(params, state, ego)
        if self.obs_type == "occupancy_grid":
            return self._observe_grid(params, state, ego)
        if self.obs_type == "lidar":
            return self._observe_lidar(params, state, ego)
        return self._observe_kinematics(params, state, ego)

    def _observe_lidar(self, params: HighwayParams, state: HighwayState, ego: int):
        """LidarObservation (reference: ExitEnv/env_lidar.json): ``[B, cells,
        2]``, per angular sector the normalized distance to the nearest vehicle
        and its closing speed along the ray."""
        C, R = self.lidar_cells, self.lidar_range
        B, V = state.x.shape
        device = state.x.device
        dx = state.x - state.x[:, ego:ego + 1]
        dy = (state.lane - state.lane[:, ego:ego + 1]) * LANE_WIDTH
        # both sums of products are fused multiply-adds in the JAX package
        dist = torch.sqrt(fma(dx, dx, dy * dy))
        angle = torch.remainder(torch.atan2(dy, dx), _TWO_PI)
        sector = torch.remainder(torch.floor(angle * recip(_TWO_PI / C)).to(torch.int64), C)
        valid = state.alive & (torch.arange(V, device=device) != ego) & (dist <= R)
        d = torch.where(valid, dist, torch.inf)
        d_min = torch.full((B, C), torch.inf, device=device).scatter_reduce(
            1, sector, d, reduce="amin")
        nearest = valid & (d <= d_min.gather(1, sector) + 1e-6)
        count = torch.zeros((B, C), device=device).scatter_add(
            1, sector, nearest.to(torch.float32)).clamp(min=1)
        # closing speed along the ray: -(relative velocity . unit ray)
        vx = state.speed - state.speed[:, ego:ego + 1]
        vy = self._lateral_speed(params, state)
        radial = fma(vx, dx, vy * dy) / torch.clamp(dist, min=1e-3)
        closing = torch.zeros((B, C), device=device).scatter_add(
            1, sector, torch.where(nearest, -radial, 0.0)) / count
        return torch.stack([torch.where(torch.isfinite(d_min), d_min * recip(R), 1.0),
                            torch.clamp(closing * recip(MAX_SPEED), -1.0, 1.0)], dim=2)

    def _directions(self, device):
        """Per-vehicle travel direction along x (+1), or None when uniform.
        TwoWayEnv gives -1 to the oncoming stream."""
        return None

    @staticmethod
    def _lateral_speed(params, state):
        """Lateral velocity from lane-change progress (the first-order pull
        of the next transition), in m/s."""
        dt = _row(params.dt, 2)
        pull = torch.minimum(torch.maximum(state.target_lane.to(torch.float32) - state.lane, -dt),
                             dt)
        return pull * LANE_WIDTH / dt

    @staticmethod
    def _sort_order(dist):
        """Stable ascending order of ``dist [B, V]``: the rank that the JAX
        package's one-hot permutation gives (ties by vehicle index)."""
        return torch.argsort(dist, dim=1, stable=True)

    def _observe_kinematics(self, params: HighwayParams, state: HighwayState, ego: int):
        """Kinematics observation ``[B, R, F]``: ego-relative, distance-sorted,
        normalized; ``obs_features == 7`` appends cos_h/sin_h headings
        (reference: HighwayEnv/env_obs_attention.json)."""
        scale = _vec(params.obs_scale)
        sx, sy, svx, svy = (scale[:, k:k + 1] for k in range(4))
        dx = state.x - state.x[:, ego:ego + 1]
        dy = (state.lane - state.lane[:, ego:ego + 1]) * LANE_WIDTH
        vx = state.speed - state.speed[:, ego:ego + 1]
        if self.obs_features >= 7:
            vy_abs = self._lateral_speed(params, state)
            vy = vy_abs - vy_abs[:, ego:ego + 1]
        else:
            vy = torch.zeros_like(vx)
        dist = dx.abs() + dy.abs()
        dist[:, ego] = -1.0  # ego first
        order = self._sort_order(dist)
        cols = [state.alive.to(torch.float32),
                torch.clamp(dx / sx, -1, 1), torch.clamp(dy / sy, -1, 1),
                torch.clamp(vx / svx, -1, 1), torch.clamp(vy / svy, -1, 1)]
        if self.obs_features >= 7:
            fwd = torch.clamp(state.speed, min=1e-3)
            heading = torch.atan2(vy_abs, fwd)
            cos_h, sin_h = torch.cos(heading), torch.sin(heading)
            cols += [cos_h, sin_h]
        rows = torch.stack(cols, dim=2).gather(1, order[:, :, None].expand(-1, -1, len(cols)))
        presence = rows[:, :, 0].clone()
        # the ego row carries absolute features, like highway-env
        ego_x = state.x[:, ego] * recip(1000.0)
        rows[:, 0] = 0.0
        rows[:, 0, 0] = 1.0
        rows[:, 0, 1] = ego_x
        if self.obs_features >= 7:
            rows[:, 0, 5] = cos_h[:, ego]
            rows[:, 0, 6] = sin_h[:, ego]
        rows = rows * presence[:, :, None]
        R = min(self.obs_vehicles, self.vehicles)
        return rows[:, :R]

    def _observe_ttc(self, params: HighwayParams, state: HighwayState, ego: int):
        """TimeToCollision observation (reference: TwoWayEnv/env.json):
        ``[B, 3, lanes, horizon]``; cell ``[l, lane, t]`` is 1 when some vehicle
        ahead in ``lane`` would be reached in ``t`` seconds at the ego's
        candidate speed ``target_speeds[l]``."""
        L, H = self.lanes, self.ttc_horizon
        B, V = state.x.shape
        device = state.x.device
        direction = self._directions(device)
        other_vx = state.speed if direction is None else state.speed * direction
        dx = state.x - state.x[:, ego:ego + 1]
        valid = state.alive & (torch.arange(V, device=device) != ego) & (dx > 0)
        lane_idx = torch.clamp(torch.round(state.lane).to(torch.int64), 0, L - 1)
        closing = _vec(params.target_speeds)[:, :, None] - other_vx[:, None, :]   # [B, 3, V]
        ttc = dx[:, None, :] / torch.clamp(closing, min=1e-3)
        tbin = torch.floor(ttc).to(torch.int64)
        ok = valid[:, None, :] & (closing > 0) & (tbin >= 0) & (tbin < H)
        cell = (lane_idx[:, None, :] * H + tbin.clamp(0, H - 1))                  # [B, 3, V]
        # a cell is 1 when any vehicle hits it; misses land in a spare column
        grid = torch.zeros((B, 3, L * H + 1), device=device).scatter_(
            2, torch.where(ok, cell, L * H), 1.0)[:, :, :L * H]
        return grid.reshape(B, 3, L, H)

    def _observe_grid(self, params: HighwayParams, state: HighwayState, ego: int):
        """OccupancyGrid observation (reference: IntersectionEnv/env_grid.json):
        ``[B, F, H, W]`` raster of ego-relative kinematics features."""
        dx = state.x - state.x[:, ego:ego + 1]
        dy = (state.lane - state.lane[:, ego:ego + 1]) * LANE_WIDTH
        vx = state.speed - state.speed[:, ego:ego + 1]
        vy = self._lateral_speed(params, state)
        heading = None
        if self.obs_features >= 7:
            heading = torch.atan2(vy, torch.clamp(state.speed, min=1e-3))
        return self._rasterize(params, state, dx, dy, vx, vy,
                               None if heading is None else (torch.cos(heading),
                                                             torch.sin(heading)))

    def _rasterize(self, params, state, dx, dy, vx, vy, headings):
        """Sum each vehicle's features into its grid cell, then clip."""
        Hc, Wc = self.grid_shape
        sy, sx = self.grid_step[1], self.grid_step[0]
        B, V = dx.shape
        device = dx.device
        scale = _vec(params.obs_scale)
        ix = torch.floor(dx * recip(sx) + Wc / 2.0).to(torch.int64)
        iy = torch.floor(dy * recip(sy) + Hc / 2.0).to(torch.int64)
        inside = state.alive & (ix >= 0) & (ix < Wc) & (iy >= 0) & (iy < Hc)
        feats = [torch.ones_like(dx),
                 torch.clamp(dx / scale[:, 0:1], -1, 1), torch.clamp(dy / scale[:, 1:2], -1, 1),
                 torch.clamp(vx / scale[:, 2:3], -1, 1), torch.clamp(vy / scale[:, 3:4], -1, 1)]
        if headings is not None:
            feats += list(headings)
        F = self.obs_features
        stack = torch.stack(feats[:F], dim=1)                                    # [B, F, V]
        cell = torch.where(inside, iy * Wc + ix, Hc * Wc)                          # [B, V]
        out = torch.zeros((B, F, Hc * Wc + 1), device=device).scatter_add(
            2, cell[:, None, :].expand(B, F, V), torch.where(inside[:, None, :], stack, 0.0))
        return torch.clamp(out[:, :, :Hc * Wc], -1.0, 1.0).reshape(B, F, Hc, Wc)

    def to_finite_mdp(self, params, state):
        """TTC-grid finite-MDP view of the first state of the batch
        (highway-env envs/common/finite_mdp.py): states are (ego speed level,
        lane, time-to-collision position), actions the 5 meta-actions; moving
        into an occupied TTC cell crashes into an absorbing state. Host numpy."""
        L, H = self.lanes, self.ttc_horizon
        V = int(params.target_speeds.shape[-1])
        grid = self._observe_ttc(params, state, 0)[0].cpu().numpy()     # [V, L, H]
        S = V * L * H + 1
        crash = S - 1
        idx = np.arange(S - 1)
        lvl, lane, t = idx // (L * H), (idx // H) % L, idx % H
        # action-conditioned next (speed level, lane); time always advances
        lvl_next = np.stack([lvl, lvl, lvl, np.minimum(lvl + 1, V - 1), np.maximum(lvl - 1, 0)],
                            axis=1)
        lane_next = np.stack([np.maximum(lane - 1, 0), lane, np.minimum(lane + 1, L - 1), lane,
                              lane], axis=1)
        t_next = np.minimum(t + 1, H - 1)[:, None].repeat(5, axis=1)
        collided = grid[lvl_next, lane_next, t_next] > 0
        nxt = (lvl_next * L + lane_next) * H + t_next
        transition = np.where(collided, crash, nxt).astype(np.int32)
        transition = np.concatenate([transition, np.full((1, 5), crash, np.int32)])
        hs = float(params.high_speed_reward)
        rl = float(params.right_lane_reward)
        cr = float(params.collision_reward)
        raw = np.where(collided, cr, hs * lvl_next / max(V - 1, 1) + rl * lane_next / max(L - 1, 1))
        reward = ((raw - cr) / (hs + rl - cr)).astype(np.float32)
        reward = np.concatenate([reward, np.zeros((1, 5), np.float32)])
        terminal = np.zeros(S, bool)
        terminal[crash] = True

        ego_level = int(state.speed_level.reshape(-1)[0])
        ego_state = int((ego_level * L + int(round(float(state.lane[0, 0])))) * H)

        class _View:
            mode = "deterministic"

        view = _View()
        view.transition, view.reward, view.terminal = transition, reward, terminal
        view.state = ego_state
        return view

    def preprocess(self, name, args):
        """highway-env planning preprocessors (reference: factory.py:97-116):
        ``simplify`` keeps the ego and the closest vehicles (highway-env's
        AbstractEnv.simplify), ``change_vehicles`` swaps the traffic's IDM/MOBIL
        preset; both return ``(env, transform)``. ``set_route_at_intersection``
        is a no-op; any other name raises ValueError."""
        if name == "simplify":
            keep = int(args[0]) if args else min(self.vehicles, 6)
            keep = min(keep, self.vehicles)
            # as in the JAX package, the smaller env keeps only the road and
            # the horizon: one ego, meta-actions, kinematics
            smaller = HighwayEnv(vehicles=keep, lanes=self.lanes,
                                 max_episode_steps=self.max_episode_steps,
                                 policy_dt=self.policy_dt)

            def transform(params, state: HighwayState):
                dist = (state.x - state.x[:, :1]).abs()
                dist[:, 0] = -1.0
                order = torch.argsort(dist, dim=1, stable=True)[:, :keep]
                return params, HighwayState(
                    x=state.x.gather(1, order), lane=state.lane.gather(1, order),
                    target_lane=state.target_lane.gather(1, order),
                    speed=state.speed.gather(1, order), speed_level=state.speed_level,
                    alive=state.alive.gather(1, order), crashed=state.crashed, t=state.t)

            return smaller, transform
        if name == "change_vehicles":
            # the robust studies' model-ensemble preprocessor (reference:
            # MergeEnv/agents/DiscreteRobustMCTSAgent/agg_def.json): the
            # traffic behaviour is an IDM/MOBIL preset of the params
            spec = args if isinstance(args, str) else (args[0] if args else "")
            over = BEHAVIOR_PRESETS.get(str(spec).rsplit(".", 1)[-1], {})

            def change(params, state):
                if over:
                    params = params._replace(**{
                        k: torch.full_like(getattr(params, k), v) for k, v in over.items()})
                return params, state

            return self, change
        if name == "set_route_at_intersection":
            return self
        raise ValueError(f"HighwayEnv has no preprocessor {name!r}")


class IntersectionEnv(HighwayEnv):
    """Crossing-streams surrogate of intersection-v0: the egos travel along
    +x; crossing traffic travels along +y through a conflict zone at the
    origin. Meta-actions control the ego speed only (SLOWER, IDLE, FASTER).

    As in the JAX package, ``transition`` (the open-loop planners' step) is
    the highway dynamics inherited from ``HighwayEnv``; ``step`` runs the
    crossing dynamics."""

    def __init__(self, vehicles: int = 8, max_episode_steps: int = 26,
                 policy_dt: float = 1.0, controlled_vehicles: int = 1,
                 obs_type: str = "kinematics", obs_features: int = 5,
                 obs_vehicles: int | None = None,
                 grid_shape: tuple = (11, 11), grid_step: tuple = (5.0, 5.0)):
        if obs_type not in ("kinematics", "occupancy_grid"):
            raise ValueError(
                f"IntersectionEnv supports kinematics/occupancy_grid, not {obs_type}")
        super().__init__(vehicles=vehicles, lanes=1, max_episode_steps=max_episode_steps,
                         policy_dt=policy_dt, controlled_vehicles=controlled_vehicles,
                         obs_type=obs_type, obs_features=obs_features,
                         obs_vehicles=obs_vehicles, grid_shape=grid_shape, grid_step=grid_step)
        self.spec = EnvSpec("intersection", max_episode_steps)

    @property
    def action_space(self):
        if self.controlled_vehicles > 1:
            return TupleSpace((Discrete(3),) * self.controlled_vehicles)
        return Discrete(3)  # SLOWER, IDLE, FASTER

    def reset(self, params, generator: torch.Generator, batch: int = 1):
        V, N = self.vehicles, self.controlled_vehicles
        device = params.dt.device
        gen_device = generator.device
        # egos approach in file from x=-60; crossing vehicles from y in [-100, -20]
        ego_x = (-60.0 - 15.0 * torch.arange(N, dtype=torch.float32, device=device)).expand(
            batch, N)
        x = torch.cat([ego_x, -100.0 + 80.0 * torch.rand(
            (batch, V - N), generator=generator, device=gen_device).to(device)], dim=1)
        speed = torch.cat([torch.full((batch, N), 10.0, device=device), 8.0 + 4.0 * torch.rand(
            (batch, V - N), generator=generator, device=gen_device).to(device)], dim=1)
        state = self._new_state(x, torch.zeros((batch, V), device=device), speed,
                                self._level0(batch, device))
        return state, self.observe(params, state)

    def step(self, params, state: HighwayState, action, generator=None, noise=None) -> StepOut:
        del generator, noise
        V, N = self.vehicles, self.controlled_vehicles
        B = state.x.shape[0]
        device = state.x.device
        frozen = state.crashed
        acts = torch.as_tensor(action, dtype=torch.int64, device=device)
        acts = acts.reshape(B) if N == 1 else acts.reshape(B, N)
        speed_level = torch.clamp(state.speed_level + (acts == 2).to(torch.int64)
                                  - (acts == 0).to(torch.int64), 0, 2)
        # ``target * 10.0 / 25.0``: XLA folds both constants into one factor
        factor = float(np.float32(10.0) * np.float32(recip(25.0)))
        level_speed = _pick(params.target_speeds, speed_level)
        idx = torch.arange(V, device=device)
        is_ego = idx == 0 if N == 1 else idx < N
        if N == 1:
            # with one ego XLA fuses ``target * factor - speed`` into one FMA
            gap = fma(level_speed[:, None], torch.tensor(factor, device=device), -state.speed)
        else:
            target_v = torch.cat([level_speed * factor, torch.zeros((B, V - N), device=device)],
                                 dim=1)
            gap = target_v - state.speed
        acc = torch.where(is_ego, 2.0 * gap, 0.0)
        dt = _row(params.dt, 2)
        speed = torch.clamp(fma(acc, dt, state.speed), 0.0, 20.0)
        x = fma(speed, dt, state.x)

        # conflict: egos on the x-axis, the others cross on the y-axis; both
        # near the origin -> crash. Egos can also rear-end each other in file.
        near = x.abs() < VEHICLE_LENGTH
        crossing_near = (near & ~is_ego).any(dim=1)
        if N == 1:
            ego_crash = (near[:, 0] & crossing_near) | state.crashed
            any_crash = ego_crash
            arrived = x[:, 0] > 25.0
            scaled_speed = torch.clamp(speed[:, 0] * recip(10.0), 0.0, 1.0)
            reward = torch.where(ego_crash, 0.0, torch.where(arrived, 1.0, 0.5 * scaled_speed))
        else:
            ego_x, ego_v = x[:, :N], speed[:, :N]
            eidx = torch.arange(N, device=device)
            rear_end = (((ego_x[:, :, None] - ego_x[:, None, :]).abs() < VEHICLE_LENGTH)
                        & (eidx[:, None] != eidx[None, :])).any(dim=2)
            per_ego_crash = (near[:, :N] & crossing_near[:, None]) | rear_end \
                | state.crashed[:, None]
            any_crash = per_ego_crash.any(dim=1)
            arrived = (ego_x > 25.0).all(dim=1)
            scaled_speed = torch.clamp(ego_v * recip(10.0), 0.0, 1.0)
            per_reward = torch.where(per_ego_crash, 0.0,
                                     torch.where(ego_x > 25.0, 1.0, 0.5 * scaled_speed))
            ego_crash = any_crash
            reward = per_reward.sum(dim=1) * recip(N)

        keep = frozen[:, None]
        new_state = HighwayState(
            x=torch.where(keep, state.x, x), lane=state.lane, target_lane=state.target_lane,
            speed=torch.where(keep, state.speed, speed), speed_level=speed_level,
            alive=state.alive, crashed=any_crash, t=state.t + 1)
        reward = torch.where(frozen, 0.0, reward)
        terminated = any_crash | arrived
        truncated = new_state.t >= self.max_episode_steps
        return StepOut(new_state, self.observe(params, new_state), reward, terminated, truncated,
                       {"crashed": ego_crash, "speed": speed[:, 0],
                        "cost": any_crash.to(torch.float32)})

    def _observe_single(self, params, state: HighwayState, ego: int):
        if self.obs_type == "occupancy_grid":
            return self._observe_grid(params, state, ego)
        return self._observe_crossing(params, state, ego)

    def _crossing_frame(self, state: HighwayState, ego: int):
        """(dx, dy, vx, vy, is_ego): crossing vehicles at (their x) on the
        y-axis relative to the ego on the x-axis; other egos at their x-axis
        offsets."""
        V, N = self.vehicles, self.controlled_vehicles
        is_ego_v = torch.arange(V, device=state.x.device) < N
        dx = torch.where(is_ego_v, state.x - state.x[:, ego:ego + 1], -state.x[:, ego:ego + 1])
        dy = torch.where(is_ego_v, 0.0, state.x)
        vx = torch.where(is_ego_v, state.speed - state.speed[:, ego:ego + 1], 0.0)
        vy = torch.where(is_ego_v, 0.0, state.speed)
        return dx, dy, vx, vy, is_ego_v

    def _observe_grid(self, params, state: HighwayState, ego: int):
        """Crossing-geometry occupancy grid."""
        dx, dy, vx, vy, is_ego_v = self._crossing_frame(state, ego)
        headings = None
        if self.obs_features >= 7:
            cos_h = torch.where(is_ego_v, 1.0, 0.0).expand_as(dx)
            headings = (cos_h, 1.0 - cos_h)
        return self._rasterize(params, state, dx, dy, vx, vy, headings)

    def _observe_crossing(self, params, state: HighwayState, ego: int):
        """Crossing-geometry kinematics ``[B, R, F]``, unsorted, the observing
        ego first."""
        V, N = self.vehicles, self.controlled_vehicles
        dx, dy, vx, vy, is_ego_v = self._crossing_frame(state, ego)
        scale = _vec(params.obs_scale)
        cols = [state.alive.to(torch.float32),
                torch.clamp(dx / scale[:, 0:1], -1, 1), torch.clamp(dy / scale[:, 1:2], -1, 1),
                torch.clamp(vx / scale[:, 2:3], -1, 1), torch.clamp(vy / scale[:, 3:4], -1, 1)]
        if self.obs_features >= 7:
            # crossing vehicles head along +y, egos along +x
            cos_h = torch.where(is_ego_v, 1.0, 0.0).expand_as(dx)
            cols += [cos_h, 1.0 - cos_h]
        rows = torch.stack(cols, dim=2)
        # the single-ego row layout: [1, x/100, 0, speed/20, 0] (+ cos_h 1)
        rows[:, ego] = 0.0
        rows[:, ego, 0] = 1.0
        rows[:, ego, 1] = state.x[:, ego] * recip(100.0)
        rows[:, ego, 3] = state.speed[:, ego] * recip(20.0)
        if self.obs_features >= 7:
            rows[:, ego, 5] = 1.0
        if N > 1 and ego != 0:
            # put the observing ego first (ego-first convention)
            order = torch.arange(V, device=rows.device)
            order[0], order[ego] = ego, 0
            rows = rows[:, order]
        R = min(self.obs_vehicles, self.vehicles)
        return rows[:, :R]


class TwoWayEnv(HighwayEnv):
    """Two-way road surrogate (highway-env two-way-v0; reference:
    scripts/configs/TwoWayEnv/env.json): the ego drives the right lane (index
    1) behind slower same-direction traffic and may overtake into the
    oncoming lane (index 0), which carries a stream traveling in -x."""

    def __init__(self, vehicles: int = 6, max_episode_steps: int = 15,
                 policy_dt: float = 1.0, oncoming: int = 3,
                 obs_type: str = "kinematics", obs_features: int = 5,
                 obs_vehicles: int | None = None, ttc_horizon: int = 10):
        if not 0 <= oncoming <= vehicles - 1:
            raise ValueError("oncoming must leave room for the ego")
        if obs_type not in ("kinematics", "ttc"):
            raise ValueError(f"TwoWayEnv supports kinematics/ttc, not {obs_type}")
        super().__init__(vehicles=vehicles, lanes=2, max_episode_steps=max_episode_steps,
                         policy_dt=policy_dt, obs_type=obs_type, obs_features=obs_features,
                         obs_vehicles=obs_vehicles, ttc_horizon=ttc_horizon)
        self.oncoming = oncoming
        self.spec = EnvSpec("two-way", max_episode_steps)

    def _directions(self, device):
        # vehicles [V - oncoming, V) travel -x in lane 0
        return torch.where(torch.arange(self.vehicles, device=device)
                           >= self.vehicles - self.oncoming, -1.0, 1.0)

    def reset(self, params, generator: torch.Generator, batch: int = 1):
        V, O = self.vehicles, self.oncoming
        S = V - 1 - O  # same-direction traffic
        device = params.dt.device
        gen_device = generator.device

        def rand(n):
            return torch.rand((batch, n), generator=generator, device=gen_device).to(device)

        # ego at 0 on lane 1; slower same-direction traffic ahead on lane 1;
        # the oncoming stream ahead on lane 0 heading back toward the ego
        same_x = 30.0 + torch.cumsum(20.0 + 10.0 * rand(S), dim=1)
        speed_same = 8.0 + 2.0 * rand(S)
        onc_x = 80.0 + torch.cumsum(30.0 + 20.0 * rand(O), dim=1)
        x = torch.cat([torch.zeros((batch, 1), device=device), same_x, onc_x], dim=1)
        lane = torch.cat([torch.ones((batch, 1 + S), device=device),
                          torch.zeros((batch, O), device=device)], dim=1)
        speed = torch.cat([torch.full((batch, 1), 15.0, device=device), speed_same,
                           torch.full((batch, O), 10.0, device=device)], dim=1)
        state = self._new_state(x, lane, speed, self._level0(batch, device))
        return state, self.observe(params, state)

    def transition(self, params: HighwayParams, state: HighwayState, action, generator=None,
                   noise=None) -> StepOut:
        del generator, noise
        V = self.vehicles
        B = state.x.shape[0]
        device = state.x.device
        frozen = state.crashed
        direction = self._directions(device)
        idx = torch.arange(V, device=device)
        is_ego = idx == 0
        is_oncoming = direction < 0
        action = torch.as_tensor(action, dtype=torch.int64, device=device).reshape(B)
        dt = _row(params.dt, 2)

        # ego meta-action (full 5-action set; LANE_LEFT = overtake)
        speed_level = torch.clamp(state.speed_level + (action == FASTER).to(torch.int64)
                                  - (action == SLOWER).to(torch.int64), 0, 2)
        lane_delta = (torch.where(action == LANE_LEFT, -1, 0)
                      + torch.where(action == LANE_RIGHT, 1, 0))[:, None]
        target_lane = torch.clamp(state.target_lane + torch.where(is_ego, lane_delta, 0), 0, 1)

        # same-direction traffic: IDM behind its leader (the oncoming stream is
        # lane-shifted out of the leader search and holds its speed)
        search_lane = torch.where(is_oncoming, state.lane + 100.0, state.lane)
        has_l, gap_l, speed_l = self._neighbor_stats(state.x, state.speed, search_lane,
                                                     search_lane, state.alive, True)
        idm = self._idm_terms(params, 10.0)
        idm_acc = self._idm_from_leader(idm, state.speed, has_l, gap_l, speed_l,
                                        fused_interaction=False)
        ego_target = _pick(params.target_speeds, speed_level)
        ego_acc = torch.minimum(torch.maximum(ego_target - state.speed[:, 0],
                                              -_row(params.idm_b, 1)), _row(params.idm_a, 1))
        acc = torch.where(is_ego, ego_acc[:, None], torch.where(is_oncoming, 0.0, idm_acc))
        speed = torch.clamp(fma(acc, dt, state.speed), MIN_SPEED, MAX_SPEED)
        x = fma(direction * speed, dt, state.x)
        lane = state.lane + torch.minimum(torch.maximum(
            target_lane.to(torch.float32) - state.lane, -dt), dt)

        # collisions: a SWEPT pairwise test (head-on pairs tunnel through the
        # overlap check in one step): a pair also collides when its relative
        # position changes sign during the step
        rel_before = state.x[:, None, :] - state.x[:, :, None]
        rel_after = x[:, None, :] - x[:, :, None]
        close_x = (rel_after.abs() < VEHICLE_LENGTH) | (rel_before * rel_after < 0.0)
        close_lane = (lane[:, None, :] - lane[:, :, None]).abs() < 0.8
        both_alive = state.alive[:, None, :] & state.alive[:, :, None]
        not_self = idx[:, None] != idx[None, :]
        ego_crash = (close_x[:, 0] & close_lane[:, 0] & both_alive[:, 0] & not_self[0]).any(dim=1) \
            | state.crashed

        keep = frozen[:, None]
        new_state = HighwayState(
            x=torch.where(keep, state.x, x), lane=torch.where(keep, state.lane, lane),
            target_lane=target_lane, speed=torch.where(keep, state.speed, speed),
            speed_level=speed_level, alive=state.alive, crashed=ego_crash, t=state.t + 1)

        # reward: speed term plus a bonus for the overtaking (left) lane
        lo = _col(params.speed_reward_range, 0, 1)
        hi = _col(params.speed_reward_range, 1, 1)
        cr, hs, rl = (_row(p, 1) for p in (params.collision_reward, params.high_speed_reward,
                                           params.right_lane_reward))
        scaled_speed = torch.clamp((speed[:, 0] - lo) / (hi - lo), 0.0, 1.0)
        left_frac = 1.0 - lane[:, 0]
        raw = self._reward_sum(cr * ego_crash.to(torch.float32), hs, scaled_speed, rl, left_frac)
        reward = (raw - cr) / (hs + rl - cr)
        reward = torch.where(frozen, 0.0, torch.clamp(reward, 0.0, 1.0))
        truncated = new_state.t >= self.max_episode_steps
        return StepOut(new_state, torch.zeros((B, 1), device=device), reward, ego_crash,
                       truncated, {"crashed": ego_crash, "speed": speed[:, 0],
                                   "cost": ego_crash.to(torch.float32)})

    def _observe_kinematics(self, params, state, ego: int):
        """Kinematics with signed velocities for the oncoming stream."""
        device = state.x.device
        direction = self._directions(device)
        scale = _vec(params.obs_scale)
        dx = state.x - state.x[:, ego:ego + 1]
        dy = (state.lane - state.lane[:, ego:ego + 1]) * LANE_WIDTH
        vx = direction * state.speed - state.speed[:, ego:ego + 1]
        vy = torch.zeros_like(vx)
        dist = dx.abs() + dy.abs()
        dist[:, ego] = -1.0
        order = self._sort_order(dist)
        cols = [state.alive.to(torch.float32),
                torch.clamp(dx / scale[:, 0:1], -1, 1), torch.clamp(dy / scale[:, 1:2], -1, 1),
                torch.clamp(vx / scale[:, 2:3], -1, 1), torch.clamp(vy / scale[:, 3:4], -1, 1)]
        if self.obs_features >= 7:
            cols += [direction.expand_as(vx), torch.zeros_like(vx)]
        rows = torch.stack(cols, dim=2).gather(1, order[:, :, None].expand(-1, -1, len(cols)))
        presence = rows[:, :, 0].clone()
        rows[:, 0] = 0.0
        rows[:, 0, 0] = 1.0
        rows[:, 0, 1] = state.x[:, ego] * recip(1000.0)
        rows[:, 0, 3] = state.speed[:, ego] * recip(MAX_SPEED)
        if self.obs_features >= 7:
            rows[:, 0, 5] = 1.0
        rows = rows * presence[:, :, None]
        R = min(self.obs_vehicles, self.vehicles)
        return rows[:, :R]


# ---------------------------------------------------------------------------
# Config-driven construction (reference env variant configs)
# ---------------------------------------------------------------------------

# highway-env behaviour presets for "other_vehicles_type" (behavior.py
# IDMVehicle / AggressiveVehicle / DefensiveVehicle / LinearVehicle) mapped
# onto the surrogate's IDM parameter space
BEHAVIOR_PRESETS = {
    "AggressiveVehicle": dict(idm_a=4.5, idm_b=6.0, idm_t0=0.8, idm_s0=5.0,
                              mobil_min_gain=0.1, mobil_b_safe=4.0),
    "DefensiveVehicle": dict(idm_a=2.0, idm_b=4.0, idm_t0=2.2, idm_s0=15.0,
                             mobil_min_gain=0.6, mobil_b_safe=1.0),
    "LinearVehicle": dict(idm_a=3.0, idm_b=5.0, idm_t0=1.5, idm_s0=10.0),
    "IDMVehicle": {},
}


def behavior_overrides(config: dict) -> dict:
    name = str(config.get("other_vehicles_type", "")).rsplit(".", 1)[-1]
    return dict(BEHAVIOR_PRESETS.get(name, {}))


def apply_param_overrides(params: HighwayParams, config: dict) -> HighwayParams:
    over = behavior_overrides(config)
    if "collision_reward" in config:
        over["collision_reward"] = config["collision_reward"]
    if "right_lane_reward" in config:
        over["right_lane_reward"] = config["right_lane_reward"]
    if "left_lane_reward" in config and "right_lane_reward" not in config:
        # TwoWayEnv keeps its left (overtake) lane bonus in the
        # right_lane_reward slot; as in the JAX package this applies to every
        # env class that reads the key
        over["right_lane_reward"] = config["left_lane_reward"]
    if "high_speed_reward" in config:
        over["high_speed_reward"] = config["high_speed_reward"]
    if over:
        params = params._replace(**{k: torch.full_like(getattr(params, k), float(v))
                                    for k, v in over.items()})
    return params


def episode_steps(config: dict, default_duration: int) -> int:
    freq = float(config.get("policy_frequency", 1))
    duration = float(config.get("duration", default_duration))
    return max(1, int(round(duration * freq)))


def obs_kwargs(config: dict) -> dict:
    """Parse the highway-env observation block into surrogate knobs."""
    obs = dict(config.get("observation") or {})
    n_ego = int(config.get("controlled_vehicles", 1))
    if obs.get("type") == "MultiAgentObservation":
        obs = dict(obs.get("observation_config") or {})
        n_ego = max(n_ego, 2)
    kind = {"TimeToCollision": "ttc", "OccupancyGrid": "occupancy_grid",
            "LidarObservation": "lidar"}.get(obs.get("type"), "kinematics")
    # 5-feature or 7-feature (heading) rows, sized by heading presence
    features = obs.get("features") or []
    kwargs = dict(controlled_vehicles=n_ego, obs_type=kind,
                  obs_features=7 if ("cos_h" in features or "sin_h" in features) else 5)
    if kind == "ttc":
        kwargs["ttc_horizon"] = int(obs.get("horizon", 10))
    if kind == "lidar":
        if "cells" in obs:
            kwargs["lidar_cells"] = int(obs["cells"])
        if "maximum_range" in obs:
            kwargs["lidar_range"] = float(obs["maximum_range"])
    if kind == "occupancy_grid":
        size = obs.get("grid_size", [[-27.5, 27.5], [-27.5, 27.5]])
        step = obs.get("grid_step", [5, 5])
        kwargs["grid_shape"] = (int(round((size[1][1] - size[1][0]) / step[1])),
                                int(round((size[0][1] - size[0][0]) / step[0])))
        kwargs["grid_step"] = (float(step[0]), float(step[1]))
    if "vehicles_count" in obs:
        kwargs["obs_vehicles"] = int(obs["vehicles_count"])
    return kwargs


def action_kwargs(config: dict) -> dict:
    act = dict(config.get("action") or {})
    if act.get("type") == "MultiAgentAction":
        act = dict(act.get("action_config") or {})
    if act.get("type") == "ContinuousAction":
        kwargs = dict(action_type="continuous")
        if "steering_range" in act:
            kwargs["steering_range"] = tuple(act["steering_range"])
        if "acceleration_range" in act:
            kwargs["acceleration_range"] = tuple(act["acceleration_range"])
        return kwargs
    return {}


def _handle(env: HighwayEnv, config: dict, device) -> EnvHandle:
    device = resolve_device(device)
    params = apply_param_overrides(env.default_params(device), config)
    return EnvHandle(env, params, config, device=device)


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    """``highway``, ``highway-v0``, ``merge-v0`` and ``exit-v0``."""
    config = dict(config or {})
    obs_kw = obs_kwargs(config)
    act_kw = action_kwargs(config)
    if act_kw.get("action_type") == "continuous":
        obs_kw["controlled_vehicles"] = 1  # continuous control is single-ego
    env = HighwayEnv(vehicles=config.get("vehicles_count", 15),
                     lanes=config.get("lanes_count", 4),
                     max_episode_steps=config.get("max_episode_steps",
                                                  episode_steps(config, 40)),
                     **obs_kw, **act_kw)
    return _handle(env, config, device)


def make_intersection(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    obs_kw = obs_kwargs(config)
    for k in ("ttc_horizon", "lidar_cells", "lidar_range"):
        obs_kw.pop(k, None)
    if obs_kw.get("obs_type") not in ("kinematics", "occupancy_grid"):
        obs_kw["obs_type"] = "kinematics"  # the crossing geometry has no ttc/lidar
    vehicles = config.get("vehicles_count",
                          config.get("initial_vehicle_count", 4)
                          + obs_kw["controlled_vehicles"] + 3)
    env = IntersectionEnv(vehicles=vehicles,
                          max_episode_steps=config.get("max_episode_steps",
                                                       episode_steps(config, 26)),
                          **obs_kw)
    return _handle(env, config, device)


def make_roundabout(config: dict | None = None, device="cuda") -> EnvHandle:
    """Roundabout surrogate (roundabout-v0): a short 2-lane circulating
    carriageway with the full 5 meta-actions."""
    config = dict(config or {})
    config.setdefault("lanes_count", 2)
    config.setdefault("vehicles_count", 10)
    config.setdefault("duration", 11)
    return make(config, device=device)


def make_twoway(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    obs_kw = obs_kwargs(config)
    for k in ("grid_shape", "grid_step", "controlled_vehicles", "lidar_cells", "lidar_range"):
        obs_kw.pop(k, None)
    if obs_kw.get("obs_type") not in ("kinematics", "ttc"):
        obs_kw["obs_type"] = "kinematics"
    env = TwoWayEnv(vehicles=config.get("vehicles_count", 6),
                    oncoming=config.get("oncoming", 3),
                    max_episode_steps=config.get("max_episode_steps",
                                                 episode_steps(config, 15)),
                    **obs_kw)
    return _handle(env, config, device)
