"""Functional classic-control environments, MountainCar and Pendulum,
batch-first.

Port of ``rl_agents_tpu/envs/classic.py``: gymnasium's MountainCar-v0 and
Pendulum-v1 dynamics (the pendulum with a discretised torque set, so that
discrete planners can drive it). Each reset's draw may be injected as
``noise``: MountainCar's initial position ``[B]``, the pendulum's initial
angle and angular velocity ``[B, 2]``; their steps draw nothing.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.math import fma, fnma, jax_index, recip
from rl_agents_torch.utils.noise import noise_tensor


class MountainCarParams(NamedTuple):
    force: Any
    gravity: Any
    goal_position: Any


class MountainCarState(NamedTuple):
    position: Any  # [B] f32
    velocity: Any  # [B] f32
    t: Any         # [B] i64
    done: Any      # [B] bool


def _uniform(generator, shape, low, high, device):
    u = torch.rand(shape, generator=generator, device=generator.device).to(device)
    return u * (high - low) + low


class MountainCarEnv(FunctionalEnv):
    """gymnasium MountainCar-v0 dynamics."""

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("mountaincar", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(3)

    @property
    def observation_space(self):
        return Box(np.array([-1.2, -0.07], np.float32), np.array([0.6, 0.07], np.float32), (2,))

    def default_params(self, device="cuda") -> MountainCarParams:
        return MountainCarParams(*(torch.tensor(v, dtype=torch.float32, device=device)
                                   for v in (0.001, 0.0025, 0.5)))

    def reset_noise(self, params, generator, batch: int = 1):
        """The initial positions, uniform in [-0.6, -0.4)."""
        return _uniform(generator, (batch,), -0.6, -0.4, params.force.device)

    def reset(self, params, generator=None, batch: int = 1, noise=None):
        device = params.force.device
        position = noise_tensor(noise, device) if noise is not None else \
            self.reset_noise(params, generator, batch)
        state = MountainCarState(position, torch.zeros_like(position),
                                 torch.zeros(batch, dtype=torch.int64, device=device),
                                 torch.zeros(batch, dtype=torch.bool, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state):
        return torch.stack([state.position, state.velocity], dim=-1)

    def step(self, params, state: MountainCarState, action, generator=None,
             noise=None) -> StepOut:
        push = (action - 1).to(torch.float32)
        slope = torch.cos(3 * state.position)
        velocity = fma(slope, -params.gravity.expand_as(slope),
                       fma(push, params.force.expand_as(push), state.velocity))
        velocity = torch.clamp(velocity, -0.07, 0.07)
        position = torch.clamp(state.position + velocity, -1.2, 0.6)
        velocity = torch.where((position <= -1.2) & (velocity < 0), 0.0, velocity)
        t = state.t + 1
        terminated = (position >= params.goal_position) | state.done
        reward = torch.where(state.done, 0.0, -1.0)
        new_state = MountainCarState(position, velocity, t, terminated)
        return StepOut(new_state, self.observe(params, new_state), reward, terminated,
                       t >= self.max_episode_steps, {})


class PendulumParams(NamedTuple):
    g: Any
    m: Any
    l: Any  # noqa: E741 (gymnasium's name)
    dt: Any
    max_torque: Any


class PendulumState(NamedTuple):
    theta: Any      # [B] f32
    theta_dot: Any  # [B] f32
    t: Any          # [B] i64


# the reward's normaliser pi^2 + 0.1 * 64 + 0.001 * 4, a constant of the program
_COST_SCALE = np.float32(np.pi ** 2 + 0.1 * 64 + 0.001 * 4)


class PendulumEnv(FunctionalEnv):
    """gymnasium Pendulum-v1 dynamics, with a discretised action set (torques
    ``linspace(-max_torque, max_torque, n)``)."""

    def __init__(self, max_episode_steps: int = 200, discrete_actions: int = 5):
        self.max_episode_steps = max_episode_steps
        self.discrete_actions = discrete_actions
        self.spec = EnvSpec("pendulum", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(self.discrete_actions)

    @property
    def observation_space(self):
        return Box(np.array([-1, -1, -8], np.float32), np.array([1, 1, 8], np.float32), (3,))

    def default_params(self, device="cuda") -> PendulumParams:
        return PendulumParams(*(torch.tensor(v, dtype=torch.float32, device=device)
                                for v in (10.0, 1.0, 1.0, 0.05, 2.0)))

    def reset_noise(self, params, generator, batch: int = 1):
        """The initial angles, uniform in [-pi, pi), and angular velocities,
        uniform in [-1, 1), as ``[batch, 2]``."""
        device = params.g.device
        return torch.stack([_uniform(generator, (batch,), -np.pi, np.pi, device),
                            _uniform(generator, (batch,), -1.0, 1.0, device)], dim=-1)

    def reset(self, params, generator=None, batch: int = 1, noise=None):
        device = params.g.device
        vals = noise_tensor(noise, device) if noise is not None else \
            self.reset_noise(params, generator, batch)
        state = PendulumState(vals[:, 0], vals[:, 1],
                              torch.zeros(batch, dtype=torch.int64, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state):
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot],
                           dim=-1)

    def torques(self, params):
        """``jnp.linspace(-max_torque, max_torque, n)``."""
        n = self.discrete_actions
        steps = torch.arange(n, dtype=torch.float32, device=params.max_torque.device)
        values = -params.max_torque + steps * (2 * params.max_torque / max(n - 1, 1))
        return torch.where(steps == n - 1, params.max_torque, values)

    def step(self, params, state: PendulumState, action, generator=None,
             noise=None) -> StepOut:
        u = self.torques(params)[jax_index(action, self.discrete_actions)]
        g, m, l, dt = params.g, params.m, params.l, params.dt
        pi = np.float32(np.pi)
        th = torch.remainder(state.theta + pi, np.float32(2 * np.pi)) - pi
        # XLA fuses each product below into the sum it feeds
        cost = fma(u * u, torch.full_like(u, 0.001),
                   fma(state.theta_dot * state.theta_dot, torch.full_like(th, 0.1), th * th))
        accel = fma((3 * g / (2 * l)).expand_as(th), torch.sin(state.theta),
                    3.0 / (m * (l * l)) * u)
        theta_dot = torch.clamp(fma(accel, dt.expand_as(accel), state.theta_dot), -8.0, 8.0)
        theta = fma(theta_dot, dt.expand_as(theta_dot), state.theta)
        t = state.t + 1
        # normalised to [0, 1] for the bound-based planners; the division by
        # the constant is a multiply by its reciprocal
        reward = fnma(cost, torch.full_like(cost, recip(_COST_SCALE)), torch.ones_like(cost))
        new_state = PendulumState(theta, theta_dot, t)
        return StepOut(new_state, self.observe(params, new_state), reward,
                       torch.zeros_like(t, dtype=torch.bool), t >= self.max_episode_steps, {})


def make_mountaincar(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = MountainCarEnv(max_episode_steps=config.get("max_episode_steps", 200))
    return EnvHandle(env, None, config, device=device)


def make_pendulum(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = PendulumEnv(max_episode_steps=config.get("max_episode_steps", 200),
                      discrete_actions=config.get("discrete_actions", 5))
    return EnvHandle(env, None, config, device=device)
