"""Plain reference of the highway surrogate: the scene reset and one
transition, single ego, the five discrete meta-actions.

A frozen, self-contained copy of the semantics the benchmark judges the
program by: IDM longitudinal dynamics for traffic, MOBIL lane changes
(safety and incentive criteria, politeness), the ego tracking one of three
target speeds, a first-order pull towards the target lane, collisions by
overlap, and highway-env's normalized reward. The arithmetic keeps the
rounding of the system it models: each product that the original fuses
into a sum is one rounding (the product of two float32 values in float64 is
exact, then one add and one cast), and a division by a constant of the
model is a multiplication by that constant's float32 reciprocal.

Everything takes a ``dtype`` for its floats: float32 as the configuration
states, bfloat16 for the control that must come out as not correct.
Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.rounding import fused, fused_neg, reciprocal

LANE_LEFT, IDLE, LANE_RIGHT, FASTER, SLOWER = 0, 1, 2, 3, 4
VEHICLE_LENGTH = 5.0
MIN_SPEED, MAX_SPEED = 0.0, 40.0


class Scene(NamedTuple):
    x: torch.Tensor            # [B, V] longitudinal position, m
    lane: torch.Tensor         # [B, V] lateral position in lanes (continuous while changing)
    target_lane: torch.Tensor  # [B, V] int64
    speed: torch.Tensor        # [B, V] m/s
    speed_level: torch.Tensor  # [B] int64 index into the ego's target speeds
    alive: torch.Tensor        # [B, V] bool
    crashed: torch.Tensor      # [B] bool
    t: torch.Tensor            # [B] int64 steps taken


class Model(NamedTuple):
    """highway-env's defaults for ``HighwayEnv`` with ``IDMVehicle`` traffic."""
    vehicles: int = 15
    lanes: int = 4
    max_steps: int = 40
    dt: float = 1.0
    target_speeds: tuple = (20.0, 25.0, 30.0)
    idm_t0: float = 1.5
    idm_a: float = 3.0
    idm_b: float = 5.0
    idm_s0: float = 10.0
    traffic_target_speed: float = 25.0
    speed_reward_range: tuple = (20.0, 30.0)
    collision_reward: float = -1.0
    right_lane_reward: float = 0.1
    high_speed_reward: float = 0.4
    politeness: float = 0.0
    min_gain: float = 0.2
    b_safe: float = 2.0


def model_of(env_config: dict) -> Model:
    """The model of a corpus env config (``vehicles_count``, ``lanes_count``,
    ``duration`` at one policy step a second)."""
    return Model(vehicles=int(env_config.get("vehicles_count", 15)),
                 lanes=int(env_config.get("lanes_count", 4)),
                 max_steps=int(env_config.get("max_episode_steps",
                                              round(float(env_config.get("duration", 40))))))


def reset(model: Model, spacing_u, lane, speed_u, dtype=torch.float32) -> Scene:
    """Scenes from draws ``[B, V]`` each: uniforms in [0, 1) for the spacing
    and the speed, lane indices. The ego (vehicle 0) starts at x = 0 on lane
    L - 1 at 25 m/s; the others lie ahead, 25 to 30 m apart, at 20 to 25 m/s."""
    B, V = spacing_u.shape
    device = spacing_u.device
    spacing = (25.0 + 5.0 * spacing_u.float()).to(dtype)
    x = torch.cumsum(spacing, dim=1) - spacing[:, :1]
    lane = lane.to(torch.int64).clone()
    lane[:, 0] = model.lanes - 1
    speed = (20.0 + 5.0 * speed_u.float()).to(dtype)
    speed = torch.where(torch.arange(V, device=device) < 1, torch.tensor(25.0, dtype=dtype,
                                                                         device=device), speed)
    return Scene(x=x, lane=lane.to(dtype), target_lane=lane, speed=speed,
                 speed_level=torch.ones(B, dtype=torch.int64, device=device),
                 alive=torch.ones((B, V), dtype=torch.bool, device=device),
                 crashed=torch.zeros(B, dtype=torch.bool, device=device),
                 t=torch.zeros(B, dtype=torch.int64, device=device))


def _neighbours(x, speed, own_lane, other_lane, alive, ahead: bool):
    """Closest same-lane neighbour of each vehicle, ahead or behind: whether
    there is one, the gap between centres, and its speed (the mean over
    vehicles tied at that gap)."""
    xi, xj = x[:, :, None], x[:, None, :]
    same_lane = (other_lane[:, None, :] - own_lane[:, :, None]).abs() < 0.5
    both = alive[:, None, :] & alive[:, :, None]
    if ahead:
        mask = (xj > xi) & same_lane & both
        gap = torch.where(mask, xj - xi, torch.inf)
    else:
        mask = (xj < xi) & same_lane & both
        gap = torch.where(mask, xi - xj, torch.inf)
    gap_min = gap.amin(dim=2)
    near = mask & (gap <= gap_min[:, :, None])
    count = near.sum(dim=2).clamp(min=1)
    return torch.isfinite(gap_min), gap_min, \
        torch.where(near, speed[:, None, :], 0.0).sum(dim=2) / count


def _idm(model: Model, speed, has_leader, gap, leader_speed, dtype):
    """IDM acceleration behind a leader (free road where there is none)."""
    dev = speed.device
    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    a, b = t(model.idm_a), t(model.idm_b)
    denominator = 2 * torch.sqrt(a * b)
    inv_v0 = 1.0 / torch.clamp(t(model.traffic_target_speed), min=1.0)
    d = torch.clamp(torch.where(has_leader, gap, 1e4) - VEHICLE_LENGTH, max=1e4)
    s_star = fused(speed, t(model.idm_t0), t(model.idm_s0), dtype) \
        + speed * (speed - leader_speed) / denominator
    ratio = torch.clamp(s_star, min=0.0) / torch.clamp(d, min=1.0)
    free = speed * inv_v0
    free2 = free * free
    free_term = fused_neg(free2, free2, t(1.0), dtype)
    inner = torch.where(has_leader, fused_neg(ratio, ratio, free_term, dtype), free_term)
    return torch.minimum(torch.maximum(a * inner, -b), a)


def _mobil(model: Model, s: Scene, target_lane, dtype):
    """MOBIL's lane choice for settled traffic, and each vehicle's IDM
    acceleration in its current lane."""
    V, L = model.vehicles, model.lanes
    dev = s.x.device
    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    x, speed, lane, alive = s.x, s.speed, s.lane, s.alive
    results = []
    for own in (lane, lane - 1.0, lane + 1.0):  # current, left, right
        has_l, gap_l, speed_l = _neighbours(x, speed, own, lane, alive, True)
        has_f, gap_f, speed_f = _neighbours(x, speed, own, lane, alive, False)
        acc = _idm(model, speed, has_l, gap_l, speed_l, dtype)
        behind_us = _idm(model, speed_f, has_f, gap_f, speed, dtype)
        behind_leader = _idm(model, speed_f, has_f & has_l, gap_f + gap_l, speed_l, dtype)
        results.append((own, has_f, acc, behind_us, behind_leader))
    _, has_f0, acc_here, behind_us0, behind_leader0 = results[0]
    old_follower_gain = torch.where(has_f0, behind_leader0 - behind_us0, 0.0)

    def candidate(k):
        cand, has_f, acc, behind_us, behind_leader = results[k]
        valid = (cand >= -0.25) & (cand <= L - 0.75)
        safe = ~has_f | (behind_us >= -t(model.b_safe))
        new_follower_gain = torch.where(has_f, behind_us - behind_leader, 0.0)
        gain = acc - acc_here + t(model.politeness) * (new_follower_gain + old_follower_gain)
        return valid & safe & (gain > t(model.min_gain)), gain

    ok_left, gain_left = candidate(1)
    ok_right, gain_right = candidate(2)
    left_wins = ok_left & (~ok_right | (gain_left >= gain_right))
    delta = torch.where(left_wins, -1, 0) + torch.where(ok_right & ~left_wins, 1, 0)
    settled = (lane - target_lane.to(dtype)).abs() < 0.05
    idx = torch.arange(V, device=dev)
    change = settled & (idx >= 1) & alive & (delta != 0)
    # two vehicles moving into one lane at once: the rear one waits if the
    # front one lies inside its desired IDM gap
    tgt = target_lane + torch.where(change, delta, 0)
    pair = change[:, :, None] & change[:, None, :] & (idx[:, None] != idx[None, :])
    same_tgt = pair & (tgt[:, :, None] == tgt[:, None, :])
    xi, xj = x[:, :, None], x[:, None, :]
    i_is_rear = (xj > xi) | ((xj == xi) & (idx[None, :] < idx[:, None]))
    desired_gap = fused(speed, t(model.idm_t0), t(VEHICLE_LENGTH + model.idm_s0), dtype)
    suppressed = (same_tgt & i_is_rear & ((xj - xi).abs() < desired_gap[:, :, None])).any(dim=2)
    change = change & ~suppressed
    return torch.clamp(target_lane + torch.where(change, delta, 0), 0, L - 1), acc_here


def transition(model: Model, s: Scene, action, dtype=torch.float32):
    """One policy step of every scene under the ego's meta-action ``[B]``.
    Returns ``(next scene, reward [B], crashed [B])``. A crashed scene stays
    as it is and earns 0."""
    V, L = model.vehicles, model.lanes
    dev = s.x.device
    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    idx = torch.arange(V, device=dev)
    is_ego = idx == 0
    act = action.to(torch.int64)
    level = torch.clamp(s.speed_level + (act == FASTER).to(torch.int64)
                        - (act == SLOWER).to(torch.int64), 0, 2)
    lane_delta = (torch.where(act == LANE_LEFT, -1, 0) + torch.where(act == LANE_RIGHT, 1, 0))
    target_lane = torch.clamp(s.target_lane + torch.where(is_ego, lane_delta[:, None], 0),
                              0, L - 1)
    target_lane, idm_acc = _mobil(model, s, target_lane, dtype)
    ego_target = torch.tensor(model.target_speeds, dtype=dtype, device=dev)[level][:, None]
    ego_acc = torch.minimum(torch.maximum(ego_target - s.speed[:, :1], -t(model.idm_b)),
                            t(model.idm_a))
    dt = t(model.dt)
    acc = torch.where(is_ego, ego_acc, idm_acc)
    speed = torch.clamp(fused(acc, dt, s.speed, dtype), MIN_SPEED, MAX_SPEED)
    x = fused(speed, dt, s.x, dtype)
    lane = s.lane + torch.minimum(torch.maximum(target_lane.to(dtype) - s.lane, -dt), dt)

    overlap = ((x[:, None, :] - x[:, :, None]).abs() < VEHICLE_LENGTH) \
        & ((lane[:, None, :] - lane[:, :, None]).abs() < 0.8) \
        & s.alive[:, None, :] & s.alive[:, :, None] & (idx[:, None] != idx[None, :])
    crashed = overlap[:, 0].any(dim=1) | s.crashed

    frozen = s.crashed[:, None]
    nxt = Scene(x=torch.where(frozen, s.x, x), lane=torch.where(frozen, s.lane, lane),
                target_lane=target_lane, speed=torch.where(frozen, s.speed, speed),
                speed_level=level, alive=s.alive, crashed=crashed, t=s.t + 1)

    lo, hi = model.speed_reward_range
    scaled = torch.clamp((speed[:, 0] - lo) / t(hi - lo), 0.0, 1.0)
    raw = fused(lane[:, 0], t(model.right_lane_reward) * reciprocal(max(L - 1, 1)),
                fused(t(model.high_speed_reward), scaled,
                      t(model.collision_reward) * crashed.to(dtype), dtype), dtype)
    cr, hs, rl = t(model.collision_reward), t(model.high_speed_reward), t(model.right_lane_reward)
    reward = (raw - cr) / (hs + rl - cr)
    reward = torch.where(s.crashed, 0.0, torch.clamp(reward, 0.0, 1.0))
    return nxt, reward, crashed
