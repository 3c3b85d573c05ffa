"""Functional goal-conditioned parking (a parking-v0 surrogate), batch-first.

Port of ``rl_agents_tpu/envs/parking.py``. The reference's ParkingEnv configs
run the CEM planner and the simple agents on highway-env's ``parking-v0``: a
kinematic car must reach a goal pose, and the reward is the negative weighted
p-norm ``-(|achieved - desired| . weights) ** 0.5`` over the features
``[x, y, vx, vy, cos_h, sin_h]`` (highway-env parking_env.py), a success once
it exceeds ``-0.12``. A kinematic bicycle takes continuous [acceleration,
steering] in [-1, 1]^2; the observation is the flat ``[achieved, desired]``
vector. The reset's draw may be injected as ``noise`` ``[B, 2]``: the goal's
x in [-20, 20) and a uniform in [0, 1) that puts it in the upper row below
0.5.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.math import fma, matvec, recip
from rl_agents_torch.utils.noise import noise_tensor

# highway-env's parking reward weights over [x, y, vx, vy, cos_h, sin_h]
_WEIGHTS = (1.0, 0.3, 0.0, 0.0, 0.02, 0.02)
_P_NORM = 0.5
_SUCCESS_THRESHOLD = 0.12
_WHEELBASE = 2.5


class ParkingParams(NamedTuple):
    accel_scale: Any
    steer_scale: Any


class ParkingState(NamedTuple):
    x: Any        # [B] f32
    y: Any
    heading: Any
    speed: Any
    goal: Any     # [B, 3] [gx, gy, gheading]
    t: Any        # [B] i64


class ParkingEnv(FunctionalEnv):
    def __init__(self, max_episode_steps: int = 100, dt: float = 0.1):
        self.max_episode_steps = max_episode_steps
        self.dt = dt
        self.spec = EnvSpec("parking", max_episode_steps)

    @property
    def action_space(self):
        return Box(-1.0, 1.0, (2,))

    @property
    def observation_space(self):
        return Box(-np.inf, np.inf, (12,))

    def default_params(self, device="cuda") -> ParkingParams:
        return ParkingParams(torch.tensor(5.0, device=device),
                             torch.tensor(np.float32(np.pi / 4), device=device))

    def _features(self, state: ParkingState):
        cos_h, sin_h = torch.cos(state.heading), torch.sin(state.heading)
        return torch.stack([state.x, state.y, state.speed * cos_h, state.speed * sin_h,
                            cos_h, sin_h], dim=-1)

    def _goal_features(self, state: ParkingState):
        zeros = torch.zeros_like(state.x)
        return torch.stack([state.goal[:, 0], state.goal[:, 1], zeros, zeros,
                            torch.cos(state.goal[:, 2]), torch.sin(state.goal[:, 2])], dim=-1)

    def reset_noise(self, params, generator, batch: int = 1):
        device = params.accel_scale.device
        u = torch.rand((batch, 2), generator=generator, device=generator.device).to(device)
        return torch.stack([u[:, 0] * 40.0 - 20.0, u[:, 1]], dim=-1)

    def reset(self, params, generator=None, batch: int = 1, noise=None):
        device = params.accel_scale.device
        vals = noise_tensor(noise, device) if noise is not None else \
            self.reset_noise(params, generator, batch)
        # a goal pose in one of the parking rows, heading +-pi/2
        up = vals[:, 1] < 0.5
        half_pi = np.float32(np.pi / 2)
        goal = torch.stack([vals[:, 0], torch.where(up, 10.0, -10.0),
                            torch.where(up, half_pi, -half_pi)], dim=-1)
        zeros = torch.zeros(batch, device=device)
        state = ParkingState(zeros, zeros, zeros, zeros, goal,
                             torch.zeros(batch, dtype=torch.int64, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state: ParkingState):
        return torch.cat([self._features(state), self._goal_features(state)], dim=-1)

    def step(self, params, state: ParkingState, action, generator=None, noise=None) -> StepOut:
        act = torch.clamp(action.reshape(action.shape[0], -1).to(torch.float32), -1.0, 1.0)
        accel = act[:, 0] * params.accel_scale
        steering = act[:, 1] * params.steer_scale
        dt = torch.full_like(accel, np.float32(self.dt))
        # kinematic bicycle (highway-env kinematics.py, slip-angle model)
        beta = torch.atan(0.5 * torch.tan(steering))
        speed = torch.clamp(fma(accel, dt, state.speed), -10.0, 10.0)
        heading = fma(speed * torch.sin(beta) * recip(_WHEELBASE), dt, state.heading)
        x = fma(speed * torch.cos(heading + beta), dt, state.x)
        y = fma(speed * torch.sin(heading + beta), dt, state.y)
        t = state.t + 1
        new_state = ParkingState(x=x, y=y, heading=heading, speed=speed, goal=state.goal, t=t)
        gap = torch.abs(self._features(new_state) - self._goal_features(new_state))
        weights = torch.tensor(_WEIGHTS, device=gap.device)
        reward = -torch.pow(matvec(gap[:, None, :], weights)[:, 0], _P_NORM)
        success = reward > -_SUCCESS_THRESHOLD
        return StepOut(new_state, self.observe(params, new_state), reward, success,
                       t >= self.max_episode_steps, {"is_success": success})


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = ParkingEnv(max_episode_steps=config.get("max_episode_steps",
                                                  config.get("duration", 100)))
    return EnvHandle(env, None, config, device=device)
