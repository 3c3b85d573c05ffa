"""Plain reference of the sailing domain (Vanderbei's "sailing strategies"
MDP, the benchmark of Kocsis and Szepesvári's UCT paper, 2006), as the
surrogate of the external ``sailing_env`` package that the SailingEnv
configs name defines it: a boat on an ``S x S`` grid sails from its start
toward the far corner ``(S - 1, S - 1)`` under a wind that drifts.

- A move is one of the 8 compass steps, clockwise from east, clipped to the
  grid.
- Its cost is the tack cost of the angular distance ``k`` (0 to 4 steps of
  45 degrees) between the heading and the direction the wind blows to,
  ``1 + k / 4 (upwind - 1)`` with ``upwind`` 3, times ``sqrt(2)`` on a
  diagonal move. The reward is ``-cost / worst``, where ``worst`` is the
  cost of a diagonal move dead upwind, and ``+1`` on reaching the goal.
- The wind stays with probability ``stability`` (0.5); else it turns one
  step, to the left (counter-clockwise) where the step's uniform draw
  ``u`` lies below ``stability + (1 - stability) / 2`` and to the right
  above.

An observation is the position over ``S`` and the wind as one of 8
indicators; ``observation`` numbers them ``(x S + y) 8 + wind`` and
``observation_keys`` gives each its 32-bit key, the observation hashed as
the program hashes observations (each component quantised to ``1e-4`` in
float32 and rounded half to even, the Weyl multipliers
``(i * 2654435761 mod 2^32) | 1``, murmur3's fmix32; 0 is kept free), since
the planner's comparison is slot by slot.

Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MOVES = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
WINDS = 8
UPWIND_COST = 3.0
STABILITY = 0.5
PRECISION = 1e-4
MASK32 = 0xFFFFFFFF


class Model(NamedTuple):
    size: int
    upwind_cost: float
    stability: float


class State(NamedTuple):
    pos: torch.Tensor   # [B, 2] int64
    wind: torch.Tensor  # [B] int64 in [0, 8)


def model_of(env_config: dict) -> Model:
    """The grid of a corpus env file (``SailingEnv/env.json``): ``size``, or
    the size an id ``sailing-<S>-v0`` names; 10 otherwise."""
    parts = str(env_config.get("id", "sailing-v0")).split("-")
    size = env_config.get("size", int(parts[1]) if len(parts) == 3 and parts[1].isdigit() else 10)
    return Model(int(size), UPWIND_COST, STABILITY)


def reset(model: Model, drawn) -> State:
    pos, wind = drawn
    return State(pos.to(torch.int64).clone(), wind.to(torch.int64).clone())


def step(model: Model, state: State, action: torch.Tensor, u: torch.Tensor,
         dtype=torch.float32):
    """``(next state, reward)`` of each row under its uniform draw ``u [B]``;
    the reward in ``dtype``."""
    dev = state.wind.device
    moves = torch.tensor(MOVES, dtype=torch.int64, device=dev)
    pos = torch.clamp(state.pos + moves[action], 0, model.size - 1)
    k = torch.abs(torch.remainder(action - state.wind + 4, WINDS) - 4)
    tack = 1.0 + torch.arange(5, device=dev).to(dtype) / 4.0 * (model.upwind_cost - 1.0)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=dev).to(dtype)
    diagonal = (action % 2) == 1
    cost = tack[k] * torch.where(diagonal, sqrt2, torch.ones_like(sqrt2))
    worst = tack[4] * sqrt2
    goal = (pos == model.size - 1).all(dim=1)
    reward = torch.where(goal, 1.0, -cost / worst)

    stability = torch.tensor(model.stability, dtype=torch.float32, device=dev).to(dtype)
    u = u.to(dtype)
    turn = torch.where(u < stability + (1.0 - stability) / 2.0, -1, 1)
    wind = torch.where(u < stability, state.wind, torch.remainder(state.wind + turn, WINDS))
    return State(pos, wind), reward


def observation(model: Model, state: State) -> torch.Tensor:
    """``[B]`` the number of each row's observation."""
    return (state.pos[:, 0] * model.size + state.pos[:, 1]) * WINDS + state.wind


def _mix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return max(h, 1)


def observation_keys(model: Model, device) -> torch.Tensor:
    """``[S * S * 8]`` int64: the 32-bit key of every observation, in
    ``observation``'s numbering. Raises where two observations share a key:
    the planner merges nodes by key, and the reference by observation."""
    S = model.size
    scale = np.float32(1) / np.float32(PRECISION)
    weights = [((i * 2654435761) & MASK32) | 1 for i in range(1, 2 + WINDS + 1)]
    keys = []
    for number in range(S * S * WINDS):
        x, y, wind = number // (S * WINDS), (number // WINDS) % S, number % WINDS
        parts = [np.float32(x) / np.float32(S), np.float32(y) / np.float32(S)]
        parts += [np.float32(wind == w) for w in range(WINDS)]
        q = [int(np.round(np.float32(p * scale))) & MASK32 for p in parts]
        keys.append(_mix(sum(a * c for a, c in zip(q, weights)) & MASK32))
    if len(set(keys)) != len(keys):
        raise ValueError(f"two observations of the {S} x {S} grid share a key")
    return torch.tensor(keys, dtype=torch.int64, device=device)
