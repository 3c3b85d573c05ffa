"""Functional CartPole, batch-first.

Port of ``rl_agents_tpu/envs/cartpole.py``: the standard gymnasium dynamics
(Euler integration of the pole/cart equations) as a pure tensor transition
over ``[B]`` states, so planners fork and step thousands of simulations at
once.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut


class CartPoleParams(NamedTuple):
    gravity: Any
    masscart: Any
    masspole: Any
    length: Any          # half pole length
    force_mag: Any
    tau: Any
    theta_threshold: Any
    x_threshold: Any


class CartPoleState(NamedTuple):
    x: Any          # [B] f32
    x_dot: Any      # [B] f32
    theta: Any      # [B] f32
    theta_dot: Any  # [B] f32
    t: Any          # [B] i64
    done: Any       # [B] bool


class CartPoleEnv(FunctionalEnv):
    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("cartpole", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(2)

    @property
    def observation_space(self):
        high = np.array([4.8, np.inf, 0.418, np.inf], dtype=np.float32)
        return Box(-high, high, (4,))

    def default_params(self, device="cuda") -> CartPoleParams:
        values = (9.8, 1.0, 0.1, 0.5, 10.0, 0.02, 12 * 2 * np.pi / 360, 2.4)
        return CartPoleParams(*(torch.tensor(v, dtype=torch.float32, device=device)
                                for v in values))

    def reset_noise(self, params, generator, batch: int = 1):
        """The reset's draw: the ``[batch, 4]`` initial values, uniform in
        [-0.05, 0.05)."""
        device = params.gravity.device
        return torch.rand((batch, 4), generator=generator, device=device) * 0.1 - 0.05

    def reset(self, params, generator, batch: int = 1, noise=None):
        device = params.gravity.device
        vals = self.reset_noise(params, generator, batch) if noise is None else noise
        state = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
                              torch.zeros(batch, dtype=torch.int64, device=device),
                              torch.zeros(batch, dtype=torch.bool, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state: CartPoleState):
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], dim=-1)

    def step(self, params: CartPoleParams, state: CartPoleState, action, generator=None,
             noise=None) -> StepOut:
        total_mass = params.masscart + params.masspole
        polemass_length = params.masspole * params.length
        force = torch.where(action == 1, params.force_mag, -params.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (force + polemass_length * state.theta_dot**2 * sintheta) / total_mass
        thetaacc = (params.gravity * sintheta - costheta * temp) / (
            params.length * (4.0 / 3.0 - params.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = state.x + params.tau * state.x_dot
        x_dot = state.x_dot + params.tau * xacc
        theta = state.theta + params.tau * state.theta_dot
        theta_dot = state.theta_dot + params.tau * thetaacc
        t = state.t + 1
        terminated = ((torch.abs(x) > params.x_threshold)
                      | (torch.abs(theta) > params.theta_threshold)
                      | state.done)
        truncated = t >= self.max_episode_steps
        # gymnasium gives reward 1.0 on every step incl. the terminating one,
        # and 0 once already done.
        reward = torch.where(state.done, 0.0, 1.0)
        new_state = CartPoleState(x, x_dot, theta, theta_dot, t, terminated)
        return StepOut(new_state, self.observe(params, new_state), reward, terminated, truncated, {})


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = CartPoleEnv(max_episode_steps=config.get("max_episode_steps", 200))
    return EnvHandle(env, None, config, device=device)
