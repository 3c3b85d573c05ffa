"""Functional double-integrator dynamics, batch-first.

Port of ``rl_agents_tpu/envs/dynamics.py`` (reference: utils/envs/dynamics.py:6-31):
the linear system x' = A x + B u with a bang-bang discrete action (or, in
the continuous variant, u in [-1, 1]) and reward max(1 - x0^2, 0).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.math import fma, fnma, matvec


class DynParams(NamedTuple):
    A: Any  # [2, 2]
    B: Any  # [2]


class DynState(NamedTuple):
    x: Any  # [B, 2] f32
    t: Any  # [B] i64


def reward_of(x):
    """``max(1 - x0^2, 0)``: XLA fuses the square into the subtraction."""
    return torch.clamp(fnma(x[:, 0], x[:, 0], torch.ones_like(x[:, 0])), min=0.0)


class DynamicsEnv(FunctionalEnv):
    def __init__(self, dt: float = 0.1, max_episode_steps: int = 100):
        self.dt = dt
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("dynamics", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(2)

    @property
    def observation_space(self):
        return Box(-np.inf, np.inf, (2,))

    def default_params(self, device="cuda") -> DynParams:
        dt = self.dt
        return DynParams(A=torch.tensor([[1.0, dt], [0.0, 1.0]], device=device),
                         B=torch.tensor([0.0, dt], device=device))

    def reset(self, params, generator=None, batch: int = 1):
        device = params.A.device
        x = torch.tensor([-1.0, 0.0], device=device).expand(batch, 2).clone()
        state = DynState(x, torch.zeros(batch, dtype=torch.int64, device=device))
        return state, state.x

    def observe(self, params, state):
        return state.x

    def control(self, action):
        return 2.0 * action.to(torch.float32) - 1.0

    def step(self, params: DynParams, state: DynState, action, generator=None,
             noise=None) -> StepOut:
        u = self.control(action)
        # ``A @ x + B * u``: the product with u is fused into the sum
        x = fma(params.B, u[:, None], matvec(params.A, state.x))
        t = state.t + 1
        return StepOut(DynState(x, t), x, reward_of(x), torch.zeros_like(t, dtype=torch.bool),
                       t >= self.max_episode_steps, {})


class ContinuousDynamicsEnv(DynamicsEnv):
    """Box-action variant: u in [-1, 1] directly (the reference's CEM plans
    over continuous action spaces, cross_entropy_method/cem.py:16-18)."""

    @property
    def action_space(self):
        return Box(np.float32(-1.0), np.float32(1.0), (1,))

    def control(self, action):
        return torch.clamp(action.reshape(action.shape[0], -1)[:, 0].to(torch.float32), -1.0, 1.0)


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    cls = ContinuousDynamicsEnv if config.get("continuous") else DynamicsEnv
    env = cls(dt=config.get("dt", 0.1), max_episode_steps=config.get("max_episode_steps", 100))
    return EnvHandle(env, None, config, device=device)
