"""Functional Sailing environment, batch-first.

Port of ``rl_agents_tpu/envs/sailing.py``, the surrogate of the external
``sailing_env`` package that the SailingEnv configs name (``sailing-v0``,
``sailing-5/10/20-v0``): the classic stochastic-shortest-path sailing domain
(Vanderbei's "sailing strategies" MDP, the UCT paper's benchmark). A boat on an
S x S grid tacks toward the far corner under a randomly drifting wind; moving
against the wind costs more.

* state: position ``[B, 2]``, wind direction ``[B]`` (one of 8), step ``[B]``;
* actions: the 8 compass moves;
* cost per move: 1 + tack penalty by the angle between heading and wind (0
  away, up to ``upwind_cost`` dead upwind; diagonal moves cost x sqrt(2));
  reward = -cost / worst_cost, in [-1, 0), and +1 on reaching the goal;
* the wind drifts each step: it stays with probability ``wind_stability``,
  else rotates one step either way. The step's noise is one uniform ``[B]``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.noise import noise_tensor, uniform

# 8 compass directions, clockwise from east
_MOVES = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
_SQRT2 = float(np.float32(np.sqrt(2.0)))  # rounded to float32 once
_DIAG = (1.0, _SQRT2) * 4
# The uniform draw that the JAX package's all-zero PRNG key gives its step
# (``uniform(split(zeros)[0])``): the deterministic planners plan against the
# wind rule it fixes. Above 0.75, so that frozen wind turns one step clockwise
# at every move.
NULL_KEY_UNIFORM = 0.8423141241073608


class SailingParams(NamedTuple):
    angle_cost: Any  # [5] f32 tack cost by angular distance heading <-> wind
    stability: Any   # [] f32
    moves: Any       # [8, 2] i64 the compass moves
    diag: Any        # [8] f32 length of each move


class SailingState(NamedTuple):
    pos: Any   # [B, 2] i64
    wind: Any  # [B] i64 in [0, 8)
    t: Any     # [B] i64


class SailingEnv(FunctionalEnv):
    def __init__(self, size: int = 10, max_episode_steps: int = 200,
                 upwind_cost: float = 3.0, wind_stability: float = 0.5):
        self.size = size
        self.max_episode_steps = max_episode_steps
        self.upwind_cost = upwind_cost
        self.wind_stability = wind_stability
        self.spec = EnvSpec("sailing", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(8)

    @property
    def observation_space(self):
        return Box(0.0, 1.0, (2 + 8,))

    def default_params(self, device="cuda") -> SailingParams:
        steps = torch.arange(5, dtype=torch.float32, device=device)
        return SailingParams(
            angle_cost=1.0 + steps / 4.0 * (self.upwind_cost - 1.0),
            stability=torch.tensor(self.wind_stability, dtype=torch.float32, device=device),
            moves=torch.tensor(_MOVES, dtype=torch.int64, device=device),
            diag=torch.tensor(_DIAG, dtype=torch.float32, device=device))

    def reset_noise(self, params: SailingParams, generator, batch: int = 1):
        """The reset's input, ``(pos [batch, 2], wind [batch])`` int64, as
        ``reset`` takes it without ``noise``: every boat at the origin, each
        wind drawn uniformly over the 8 directions on ``generator``'s device.
        A caller that plans from other positions hands them to ``reset`` as
        ``noise`` instead."""
        device = params.stability.device
        wind = torch.randint(0, 8, (batch,), generator=generator, device=generator.device)
        return torch.zeros((batch, 2), dtype=torch.int64, device=device), wind.to(device)

    def reset(self, params: SailingParams, generator, batch: int = 1, noise=None):
        """``batch`` boats at their start: ``noise``, positions ``[batch, 2]``
        and winds ``[batch]``, where it is given, else ``reset_noise``'s."""
        device = params.stability.device
        pos, wind = self.reset_noise(params, generator, batch) if noise is None else noise
        state = SailingState(
            pos=torch.as_tensor(pos, dtype=torch.int64, device=device).reshape(batch, 2).clone(),
            wind=torch.as_tensor(wind, dtype=torch.int64, device=device).reshape(batch).clone(),
            t=torch.zeros(batch, dtype=torch.int64, device=device))
        return state, self.observe(params, state)

    def observe(self, params, state: SailingState):
        winds = torch.arange(8, device=state.wind.device)
        return torch.cat([state.pos.to(torch.float32) / self.size,
                          (state.wind[:, None] == winds).to(torch.float32)], dim=1)

    def null_noise(self, batch: int, device):
        return torch.full((batch,), NULL_KEY_UNIFORM, dtype=torch.float32, device=device)

    def step(self, params: SailingParams, state: SailingState, action, generator=None,
             noise=None) -> StepOut:
        device = state.wind.device
        pos = torch.clamp(state.pos + params.moves[action], 0, self.size - 1)
        # angular distance between heading and the direction the wind blows to
        delta = torch.abs(torch.remainder(action - state.wind + 4, 8) - 4)
        cost = params.angle_cost[delta] * params.diag[action]
        worst = params.angle_cost[4] * _SQRT2

        u = noise_tensor(noise, device) if noise is not None else uniform(
            state.wind.shape, generator, device)
        stay = u < params.stability
        left = u < params.stability + (1.0 - params.stability) / 2.0
        wind = torch.where(stay, state.wind,
                           torch.remainder(state.wind + torch.where(left, -1, 1), 8))

        arrived = (pos == self.size - 1).all(dim=1)
        reward = torch.where(arrived, 1.0, -cost / worst)
        t = state.t + 1
        new_state = SailingState(pos=pos, wind=wind, t=t)
        return StepOut(new_state, self.observe(params, new_state), reward, arrived,
                       t >= self.max_episode_steps, {"cost": cost})

    def transition(self, params: SailingParams, state: SailingState, action, generator=None,
                   noise=None) -> StepOut:
        """``step``, except that where neither ``generator`` nor ``noise`` is
        given the wind turns under ``null_noise``, the one fixed draw (``step``
        raises there)."""
        if generator is None and noise is None:
            noise = self.null_noise(state.wind.shape[0], state.wind.device)
        return self.step(params, state, action, generator, noise)


class SailingMDPAccessor:
    """Exact finite-MDP view of the sailing domain for the Value Iteration
    agent and the planner-study oracle (states = S^2 positions x 8 winds,
    sparse transitions over the 3 wind outcomes). Duck-types the reference's
    ``env.mdp`` contract (value_iteration.py:14) like the finite MDP's
    accessor."""

    mode = "sparse"

    def __init__(self, env: SailingEnv, params: SailingParams, handle):
        S = env.size
        self._S, self._handle = S, handle
        N, A, K = S * S * 8, 8, 3
        x = np.arange(N) // (S * 8)
        y = (np.arange(N) // 8) % S
        w = np.arange(N) % 8
        moves = np.asarray(_MOVES)
        nx = np.clip(x[:, None] + moves[None, :, 0], 0, S - 1)     # [N, A]
        ny = np.clip(y[:, None] + moves[None, :, 1], 0, S - 1)
        angle_cost = params.angle_cost.cpu().numpy()
        delta = np.abs((np.arange(A)[None, :] - w[:, None] + 4) % 8 - 4)
        cost = angle_cost[delta] * np.asarray(_DIAG, np.float32)[None, :]
        worst = angle_cost[4] * np.sqrt(2.0)
        arrived = (nx == S - 1) & (ny == S - 1)
        self.reward = np.where(arrived, 1.0, -cost / worst).astype(np.float32)
        wind_next = np.stack([(w - 1) % 8, w, (w + 1) % 8], axis=1)  # [N, K]
        self.next = ((nx[:, :, None] * S + ny[:, :, None]) * 8
                     + wind_next[:, None, :]).astype(np.int32)       # [N, A, K]
        stability = float(params.stability)
        side = (1.0 - stability) / 2.0
        self.transition = np.broadcast_to(
            np.array([side, stability, side], np.float32), (N, A, K)).copy()
        self.terminal = ((x == S - 1) & (y == S - 1))

    @property
    def state(self):
        st = self._handle.state
        pos = st.pos[0].cpu().numpy()
        return int((pos[0] * self._S + pos[1]) * 8 + int(st.wind[0]))


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    """Build from a reference SailingEnv config: ``sailing-<S>-v0`` ids carry
    the grid size; ``sailing-v0`` takes it from the ``size`` key."""
    config = dict(config or {})
    env_id = str(config.get("id", "sailing-v0"))
    parts = env_id.split("-")
    size = config.get("size", int(parts[1]) if len(parts) == 3 and
                      parts[1].isdigit() else 10)
    env = SailingEnv(size=size,
                     max_episode_steps=config.get("max_episode_steps", 20 * size))
    handle = EnvHandle(env, None, config, device=device)
    handle.mdp = SailingMDPAccessor(env, handle.params, handle)
    return handle
