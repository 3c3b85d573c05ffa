"""Functional MiniGrid surrogates for the GridWorld planning study, batch-first.

Port of ``rl_agents_tpu/envs/minigrid.py``. The reference's GridWorld configs
(scripts/configs/GridWorld/*.json) run planners on ``gym_minigrid``'s
``MiniGrid-Empty-16x16-v0`` (reach the goal corner) and the study fork's
``MiniGrid-Collect[-Stochastic]-9x9-v0`` (collect scattered items; the
stochastic variant drops moves). The surrogates keep the same decision
problems:

* agent state: position, facing direction (4-way) and the collected mask;
* actions: MiniGrid's movement triple [turn left, turn right, forward];
* observation: ``[x / S, y / S, direction one-hot, collected mask]``;
* Empty: reward ``1 - 0.9 * t / max_steps`` on reaching the goal, terminal;
  Collect: +1 per item stepped on, terminal once all are collected;
  Stochastic: the action is dropped where the step's uniform ``noise``
  falls below ``stochasticity``.

The item layout is drawn once at construction from
``np.random.default_rng(seed)``, as the JAX package draws it, so that the
two packages lay out the same grids.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.envs.gridenv import null_uniform
from rl_agents_torch.utils.math import fnma, recip
from rl_agents_torch.utils.noise import noise_tensor

TURN_LEFT, TURN_RIGHT, FORWARD = 0, 1, 2
# direction -> displacement (MiniGrid: 0 right, 1 down, 2 left, 3 up)
_DIR_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))


class MiniGridParams(NamedTuple):
    stochasticity: Any  # [] f32
    items: Any          # [K, 2] i64 item cells


class MiniGridState(NamedTuple):
    pos: Any        # [B, 2] i64 cell
    dir: Any        # [B] i64 facing
    collected: Any  # [B, K] bool (K = 1, unused, for Empty)
    t: Any          # [B] i64


def item_cells(size: int, items: int, seed: int):
    """The item layout of a grid: ``items`` distinct interior cells."""
    rng = np.random.default_rng(seed)
    cells = rng.choice((size - 2) * (size - 2), size=items, replace=False)
    return tuple((int(1 + c % (size - 2)), int(1 + c // (size - 2))) for c in cells)


class MiniGridEnv(FunctionalEnv):
    def __init__(self, size: int = 16, task: str = "empty", items: int = 4,
                 stochasticity: float = 0.0, max_episode_steps: int = 100, seed: int = 0):
        if task not in ("empty", "collect"):
            raise ValueError(f"Unknown task {task}")
        self.size = size
        self.task = task
        self.items = items if task == "collect" else 1
        self.stochasticity = stochasticity
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec(f"minigrid-{task}", max_episode_steps)
        self.item_cells = item_cells(size, self.items, seed)

    @property
    def action_space(self):
        return Discrete(3)

    @property
    def observation_space(self):
        return Box(0.0, 1.0, (2 + 4 + self.items,))

    def default_params(self, device="cuda") -> MiniGridParams:
        return MiniGridParams(
            torch.tensor(self.stochasticity, dtype=torch.float32, device=device),
            torch.tensor(self.item_cells, dtype=torch.int64, device=device))

    def reset(self, params, generator=None, batch: int = 1):
        device = params.items.device
        state = MiniGridState(pos=torch.ones((batch, 2), dtype=torch.int64, device=device),
                              dir=torch.zeros(batch, dtype=torch.int64, device=device),
                              collected=torch.zeros((batch, self.items), dtype=torch.bool,
                                                    device=device),
                              t=torch.zeros(batch, dtype=torch.int64, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state: MiniGridState):
        device = state.pos.device
        # the division by the grid's size is a multiply by its reciprocal in XLA
        return torch.cat([
            state.pos.to(torch.float32) * recip(self.size),
            (state.dir[:, None] == torch.arange(4, device=device)).to(torch.float32),
            state.collected.to(torch.float32)], dim=1)

    def null_noise(self, batch: int, device):
        return torch.full((batch,), null_uniform(), dtype=torch.float32, device=device)

    def step(self, params, state: MiniGridState, action, generator=None, noise=None) -> StepOut:
        device = state.pos.device
        u = noise_tensor(noise, device) if noise is not None else torch.rand(
            state.t.shape, generator=generator, device=generator.device).to(device)
        # the stochastic drop (the reference's noise model, gridenv.py:27-29)
        act = torch.where(u < params.stochasticity, -1, action)
        new_dir = (state.dir + torch.where(act == TURN_RIGHT, 1, 0)
                   + torch.where(act == TURN_LEFT, 3, 0)) % 4
        dir_vec = torch.tensor(_DIR_VEC, dtype=torch.int64, device=device)
        fwd = torch.clamp(state.pos + dir_vec[new_dir], 1, self.size - 2)  # walls
        pos = torch.where((act == FORWARD)[:, None], fwd, state.pos)
        t = state.t + 1
        if self.task == "empty":
            done = (pos == self.size - 2).all(dim=1)
            # 1 - 0.9 t / max_steps: XLA folds 0.9 and the reciprocal of the
            # constant into one factor and fuses the product into the subtraction
            steps = t.to(torch.float32)
            factor = float(np.float32(0.9) * np.float32(recip(self.max_episode_steps)))
            reward = torch.where(done, fnma(steps, torch.full_like(steps, factor),
                                            torch.ones_like(steps)), 0.0)
            collected = state.collected
        else:
            on_item = (pos[:, None, :] == params.items).all(dim=2)
            reward = (on_item & ~state.collected).to(torch.float32).sum(dim=1)
            collected = state.collected | on_item
            done = collected.all(dim=1)
        new_state = MiniGridState(pos=pos, dir=new_dir, collected=collected, t=t)
        return StepOut(new_state, self.observe(params, new_state), reward, done,
                       t >= self.max_episode_steps, {})


def parse_id(env_id: str):
    """The task, the grid size and whether the id names the stochastic
    variant, from a MiniGrid id (``MiniGrid-Collect-Stochastic-9x9-v0``)."""
    parts = env_id.split("-")
    task = "collect" if "Collect" in parts else "empty"
    size = next((int(p.split("x")[0]) for p in parts
                 if "x" in p and p.split("x")[0].isdigit()), 16)
    return task, size, "Stochastic" in parts


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    """Build from a GridWorld config: the MiniGrid id encodes the task and the
    grid size."""
    config = dict(config or {})
    task, size, stochastic = parse_id(config.get("id", "MiniGrid-Empty-16x16-v0"))
    env = MiniGridEnv(size=size, task=task, items=config.get("items", 4),
                      stochasticity=config.get("stochasticity", 0.1 if stochastic else 0.0),
                      max_episode_steps=config.get("max_episode_steps", 4 * size * size),
                      seed=config.get("seed", 0))
    return EnvHandle(env, None, config, device=device)
