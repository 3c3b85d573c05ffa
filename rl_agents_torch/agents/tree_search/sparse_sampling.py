"""Sparse Sampling (Kearns et al.), level-synchronous and batch-first.

Port of ``rl_agents_tpu/agents/tree_search/sparse_sampling.py`` (reference:
tree_search/sparse_sampling.py:11-103). Level d of each of B trees holds its
``(A * C) ** d`` sampled states; one env step over ``[B, n, A, C]`` expands a
level, and a backward pass computes
``V_d = max_a [mean_c r + gamma * mean_c V_{d+1}]``.

(As in the JAX package, the sample mean of the rewards is used, the Kearns
estimator; the reference adds the last sampled reward, sparse_sampling.py:87.)

The env's draws of level d are ``noise[d]``, ``[B, n, A, C, ...]`` in the
JAX package's key layout ``split(sub, n * A * C).reshape(n, A, C, 2)``; without
it the env draws from ``generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, recip
from rl_agents_torch.utils.noise import noise_tensor


def sparse_sampling_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                         num_actions: int, horizon: int, samples: int, gamma: float,
                         noise=None, device="cuda"):
    """Plan B trees from ``states0``. Returns ``(action [B], q_root [B, A])``.
    ``noise`` is a sequence of ``horizon`` env draws, one per level."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, C, H = num_actions, samples, horizon
    B = states0[0].shape[0]
    f32 = torch.float32
    g32 = torch.tensor(np.float32(gamma), device=device)
    mean_scale = torch.tensor(recip(C), dtype=f32, device=device)
    actions = torch.arange(A, device=device)[:, None].expand(A, C)

    # forward: expand levels 0..H-1; ``states`` is [B * n, ...]
    states = states0
    dones = torch.zeros(B, dtype=torch.bool, device=device)
    level_rewards, level_dones = [], []
    for d in range(H):
        n = (A * C) ** d
        rep = type(states)(*(x.repeat_interleave(A * C, dim=0) for x in states))
        action = actions.reshape(1, A * C).expand(B * n, A * C).reshape(-1)
        env_noise = None
        if noise is not None:
            env_noise = noise_tensor(noise[d], device)
            env_noise = env_noise.reshape((B * n * A * C,) + env_noise.shape[4:])
        out = env.transition(params, rep, action, generator, env_noise)
        prev_done = dones.reshape(B, n, 1, 1)
        reward = torch.where(prev_done, 0.0, out.reward.to(f32).reshape(B, n, A, C))
        done = out.terminated.reshape(B, n, A, C) | prev_done
        level_rewards.append(reward)
        level_dones.append(done)
        states = out.state
        dones = done.reshape(-1)

    # backward: V_H = 0; Q_d = mean_c r + gamma * mean_c V_{d+1}
    v = torch.zeros((B, (A * C) ** H), dtype=f32, device=device)
    q = None
    for d in reversed(range(H)):
        n = (A * C) ** d
        v_next = torch.where(level_dones[d], 0.0, v.reshape(B, n, A, C))
        # XLA divides a mean by multiplying with the reciprocal and fuses the
        # multiply-add
        r_mean = level_rewards[d].sum(dim=3) * mean_scale
        v_mean = v_next.sum(dim=3) * mean_scale
        q = fma(g32, v_mean, r_mean)  # [B, n, A]
        v = q.amax(dim=2)
    q_root = q[:, 0]
    return q_root.argmax(dim=1), q_root


class SparseSamplingAgent(AbstractTreeSearchAgent):
    """(reference: sparse_sampling.py:99-103), planning one tree (B = 1)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({"budget": 100, "horizon": None, "C": 2})
        return config

    def make_planner(self):
        A = self.env.action_space.n
        C = self.config["C"]
        if not self.config.get("horizon"):
            # the deepest horizon whose product tree fits in the step budget
            budget = max(self.config["budget"], A * C)
            self.config["horizon"] = max(int(np.log(budget) / np.log(A * C)), 1)

    def planner_plan(self, env, observation):
        functional = env.functional
        action, q_root = sparse_sampling_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n, horizon=int(self.config["horizon"]),
            samples=int(self.config["C"]), gamma=float(self.config["gamma"]), device=self.device)
        self.last_plan_data = q_root
        return [int(action[0])]
