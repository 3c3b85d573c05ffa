"""Functional GridEnv and LineEnv, batch-first.

Port of ``rl_agents_tpu/envs/gridenv.py`` (reference: utils/envs/gridenv.py:6-117):
a 2-D walk with a radial reward bump (GridEnv) and a noisy 1-D line with
terminal walls (LineEnv). Each step's draw is injected as ``noise``: GridEnv's
uniform ``[B]`` in [0, 1) (the action is dropped below ``stochasticity``),
LineEnv's coin ``[B]`` in {0, 1}.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.math import fnma, jax_index, recip
from rl_agents_torch.utils.noise import NULL_KEY, noise_tensor, threefry_randint, threefry_uniform

REWARD_CENTER = (10.0, 10.0)
REWARD_RADIUS = 5.0

# displacement per action: right, left, up, down, then 4 diagonals
_GRID_MOVES = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))


@functools.lru_cache(maxsize=None)
def _grid_constants(device: torch.device):
    """``_GRID_MOVES`` and ``REWARD_CENTER`` as tensors on ``device``, made
    once: a step then copies nothing from the host, so a CUDA graph can
    capture it (MDP-GapE's episode graph does, on ``gridenv_stoch``)."""
    return (torch.tensor(_GRID_MOVES, dtype=torch.float32, device=device),
            torch.tensor(REWARD_CENTER, device=device))


def null_uniform() -> float:
    """``jax.random.uniform`` under JAX's all-zero key: the draw that the
    deterministic planners step a stochastic env with."""
    return float(threefry_uniform(NULL_KEY, (), 0.0, 1.0))


class GridParams(NamedTuple):
    stochasticity: Any  # [] f32


class GridState(NamedTuple):
    x: Any  # [B, 2] f32 position
    t: Any  # [B] i64


class GridEnv(FunctionalEnv):
    def __init__(self, use_diagonals: bool = False, stochasticity: float = 0.0,
                 max_episode_steps: int = 100):
        self.use_diagonals = use_diagonals
        self.stochasticity = stochasticity
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("gridenv", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(8 if self.use_diagonals else 4)

    @property
    def observation_space(self):
        return Box(-np.inf, np.inf, (2,))

    def default_params(self, device="cuda") -> GridParams:
        return GridParams(torch.tensor(self.stochasticity, dtype=torch.float32, device=device))

    def reset(self, params, generator=None, batch: int = 1):
        device = params.stochasticity.device
        state = GridState(torch.zeros((batch, 2), device=device),
                          torch.zeros(batch, dtype=torch.int64, device=device))
        return state, state.x

    def observe(self, params, state):
        return state.x

    def null_noise(self, batch: int, device):
        return torch.full((batch,), null_uniform(), dtype=torch.float32, device=device)

    def step(self, params, state: GridState, action, generator=None, noise=None) -> StepOut:
        device = state.x.device
        u = noise_tensor(noise, device) if noise is not None else torch.rand(
            state.t.shape, generator=generator, device=generator.device).to(device)
        # with probability ``stochasticity`` the action is dropped (no move),
        # the reference's action = -1 branch (gridenv.py:27-29)
        drop = u < params.stochasticity
        moves, center = _grid_constants(device)
        x = state.x + torch.where(drop[:, None], 0.0, moves[jax_index(action, len(_GRID_MOVES))])
        gap = center - x
        # the squared distance is a multiply and one fused multiply-add; the
        # division by the constant radius^2 is a multiply by its reciprocal,
        # fused into the subtraction
        square = torch.addcmul((gap[:, 0] * gap[:, 0]).double(), gap[:, 1].double(),
                               gap[:, 1]).to(torch.float32)
        reward = torch.clamp(fnma(square, torch.full_like(square, recip(REWARD_RADIUS ** 2)),
                                  torch.ones_like(square)), 0.0, 1.0)
        t = state.t + 1
        return StepOut(GridState(x, t), x, reward, torch.zeros_like(t, dtype=torch.bool),
                       t >= self.max_episode_steps, {})


class LineParams(NamedTuple):
    wall: Any  # [] i64: the walk ends at |x| >= wall


class LineState(NamedTuple):
    x: Any     # [B] i64
    t: Any     # [B] i64
    done: Any  # [B] bool


class LineEnv(FunctionalEnv):
    """Noisy 1-D walk; reward 1 while |x| <= 1, terminal at |x| >= 2
    (reference: gridenv.py:69-105; registered with max_episode_steps=10)."""

    def __init__(self, max_episode_steps: int = 10):
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("line_env", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(2)

    @property
    def observation_space(self):
        return Box(-np.inf, np.inf, ())

    def default_params(self, device="cuda") -> LineParams:
        return LineParams(torch.tensor(2, dtype=torch.int64, device=device))

    def reset(self, params, generator=None, batch: int = 1):
        device = params.wall.device
        zeros = torch.zeros(batch, dtype=torch.int64, device=device)
        state = LineState(zeros, zeros, torch.zeros(batch, dtype=torch.bool, device=device))
        return state, state.x

    def observe(self, params, state):
        return state.x

    def null_noise(self, batch: int, device):
        return torch.full((batch,), threefry_randint(NULL_KEY, 2), dtype=torch.int64,
                          device=device)

    def step(self, params, state: LineState, action, generator=None, noise=None) -> StepOut:
        device = state.x.device
        coin = torch.as_tensor(noise, device=device).to(torch.int64) if noise is not None \
            else torch.randint(0, 2, state.x.shape, generator=generator,
                               device=generator.device).to(device)
        delta = torch.where(action == 1, 1, -1)
        x = state.x + torch.div(delta + 2 * coin - 1, 2, rounding_mode="floor")
        done = state.done | (torch.abs(x) >= params.wall)
        reward = torch.where(state.done, 0.0, torch.where(torch.abs(x) <= 1, 1.0, 0.0))
        t = state.t + 1
        new_state = LineState(torch.where(state.done, state.x, x), t, done)
        return StepOut(new_state, new_state.x, reward, done, t >= self.max_episode_steps, {})


def make_grid(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = GridEnv(use_diagonals=config.get("use_diagonals", False),
                  stochasticity=config.get("stochasticity", 0.0),
                  max_episode_steps=config.get("max_episode_steps", 100))
    return EnvHandle(env, None, config, device=device)


def make_line(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = LineEnv(max_episode_steps=config.get("max_episode_steps", 10))
    return EnvHandle(env, None, config, device=device)
