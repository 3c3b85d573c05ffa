"""BRUE: Best Recommendation with Uniform Exploration, batch-first.

Port of ``rl_agents_tpu/agents/tree_search/brue.py`` (reference:
tree_search/brue.py:11-123): uniform random rollouts (brue.py:24-33); each
rollout's transitions build a decision/chance node chain keyed by
observation (``ops/hashing.py::obs_key``), then a reversed update backs up
the estimated returns ``r + gamma * estimate(next)``, where ``estimate``
follows the best-valued chance child and count-weighted random outcomes
(brue.py:35-64). The budget is counted in env steps (brue.py:66-71).

Every arena field carries a leading tree axis B. The episode loop stops once
every tree has spent its budget, and an episode's chain and update stop at
the longest live rollout of its active trees (one read-back an episode each);
the JAX package runs the remaining steps and episodes as no-ops.

Randomness follows the JAX package's key chain: each episode takes one
subkey for its rollout and each live update one for its estimate, so a
tree's draws are a stream indexed by the number of subkeys taken so far.
``BRUENoise`` injects that stream (a test replays the JAX package's keys);
without it the draws come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent, allocation
from rl_agents_torch.agents.tree_search.mcts import discount_table
from rl_agents_torch.agents.tree_search.mcts_dpw import _put
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import gumbel, noise_tensor


class BRUETree(NamedTuple):
    # decision (outcome) nodes: reward statistics
    d_count: Any       # [B, Nd] i64
    d_reward: Any      # [B, Nd] f32 mean reward R(s, a, s')
    d_children: Any    # [B, Nd, A] i64 chance ids
    d_depth: Any       # [B, Nd] i64
    # chance nodes: value statistics and observation-keyed children
    c_count: Any       # [B, Nc] i64
    c_value: Any       # [B, Nc] f32 mean estimated return
    c_child_keys: Any  # [B, Nc, W] i64
    c_children: Any    # [B, Nc, W] i64 decision ids
    c_n_children: Any  # [B, Nc] i64
    d_used: Any        # [B] i64
    c_used: Any        # [B] i64


class BRUENoise(NamedTuple):
    """Each tree's draws for the ``i``-th subkey of its chain, ``[I, B, ...]``:
    ``rollout_actions [I, B, H]`` and ``rollout_env [I, B, H, ...]`` (None for
    an env that draws nothing) when the subkey drives a rollout,
    ``estimate [I, B, H, W]`` Gumbel draws when it drives an estimate, and
    ``final [I, B, A]`` the Gumbel draw of the root's tie-break when the
    chain stops after ``i`` subkeys."""

    rollout_actions: Any
    rollout_env: Any
    estimate: Any
    final: Any


class _Draws:
    """Per-tree cursors into injected ``BRUENoise``, or fresh draws."""

    def __init__(self, noise: BRUENoise | None, generator, batch: int, horizon: int,
                 num_actions: int, width: int, device):
        self.generator, self.device = generator, device
        self.B, self.H, self.A, self.W = batch, horizon, num_actions, width
        self.rows = torch.arange(batch, device=device)
        self.cursor = torch.zeros(batch, dtype=torch.int64, device=device)
        if noise is None:
            if generator is None:
                raise ValueError("brue_plan needs a generator or noise")
            self.noise = None
            return

        def as_tensor(x, dtype=None):
            if x is None:
                return None
            if dtype is not None:
                x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
                return x.to(device=device, dtype=dtype)
            return noise_tensor(x, device)

        self.noise = BRUENoise(as_tensor(noise.rollout_actions, torch.int64),
                               as_tensor(noise.rollout_env), as_tensor(noise.estimate),
                               as_tensor(noise.final))

    def _take(self, x, advance):
        value = x[self.cursor.clamp(max=x.shape[0] - 1), self.rows]
        self.cursor += advance
        return value

    def rollout(self):
        """``(actions [B, H], env noise [B, H, ...] or None)``; every tree
        takes one subkey."""
        if self.noise is None:
            actions = torch.randint(0, self.A, (self.B, self.H), generator=self.generator,
                                    device=self.generator.device).to(self.device)
            return actions, None
        env = None if self.noise.rollout_env is None else \
            self.noise.rollout_env[self.cursor.clamp(max=self.noise.rollout_env.shape[0] - 1),
                                   self.rows]
        return self._take(self.noise.rollout_actions, 1), env

    def estimate(self, live):
        """Gumbel draws ``[B, H, W]`` of an estimate; live trees take a subkey."""
        if self.noise is None:
            return gumbel((self.B, self.H, self.W), self.generator, self.device)
        return self._take(self.noise.estimate, live.to(torch.int64))

    def skip(self, episodes: int):
        """Episodes that no tree runs still take their rollout subkey."""
        self.cursor += episodes

    def final(self):
        if self.noise is None:
            return gumbel((self.B, self.A), self.generator, self.device)
        return self._take(self.noise.final, 0)


def _estimate(tree: BRUETree, rows, d_node, draws, discount, horizon: int):
    """The best-action, count-weighted random-outcome walk from ``d_node``
    (reference: brue.py:52-64): the discounted mean rewards along it."""
    f32 = torch.float32
    W = tree.c_children.shape[2]
    slots = torch.arange(W, device=rows.device)
    node = d_node
    ret = torch.zeros(node.shape, dtype=f32, device=rows.device)
    live = torch.ones(node.shape, dtype=torch.bool, device=rows.device)
    for d in range(horizon):
        ch = tree.d_children[rows, node]
        valid = ch >= 0
        chs = ch.clamp(min=0)
        cvals = tree.c_value.gather(1, chs)
        best_a = torch.where(valid, cvals, -torch.inf).argmax(dim=1)
        best_chance = ch.gather(1, best_a[:, None]).squeeze(1).clamp(min=0)
        bc_children = tree.c_children[rows, best_chance]
        bc_n = tree.c_n_children[rows, best_chance]
        cc_counts = torch.where(bc_children >= 0,
                                tree.d_count.gather(1, bc_children.clamp(min=0)), 0)
        counts = torch.where(slots < bc_n[:, None], cc_counts, 0)
        logits = torch.where(counts > 0, torch.log(counts.to(f32)), -torch.inf)
        slot = (logits + draws[:, d]).argmax(dim=1)
        nxt = bc_children.gather(1, slot[:, None]).squeeze(1)
        ok = live & valid.any(dim=1) & (bc_n > 0) & (nxt >= 0)
        r_nxt = tree.d_reward[rows, nxt.clamp(min=0)]
        ret = ret + torch.where(ok, discount[d] * r_nxt, 0.0)
        node = torch.where(ok, nxt, node)
        live = ok
    return ret


def _running_mean(old, new, count):
    """``(n - 1) / n * old + new / n``, the product and the sum fused into
    one multiply-add as XLA compiles them."""
    n = count.to(torch.float32)
    return fma((n - 1) / n, old, new / n)


def brue_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
              num_actions: int, budget: int, horizon: int, gamma: float, width: int = 8,
              noise: BRUENoise | None = None, device="cuda"):
    """Plan B trees from ``states0``. Returns ``(action [B], BRUETree)``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, W, H = num_actions, width, horizon
    B = states0[0].shape[0]
    f32 = torch.float32
    max_episodes = budget  # each episode spends at least one step
    Nd = Nc = 1 + max_episodes * H

    def full(shape, fill, dtype=torch.int64):
        return torch.full(shape, fill, dtype=dtype, device=device)

    tree = BRUETree(
        d_count=full((B, Nd), 0), d_reward=full((B, Nd), 0.0, f32),
        d_children=full((B, Nd, A), -1), d_depth=full((B, Nd), 0),
        c_count=full((B, Nc), 0), c_value=full((B, Nc), 0.0, f32),
        c_child_keys=full((B, Nc, W), 0), c_children=full((B, Nc, W), -1),
        c_n_children=full((B, Nc), 0), d_used=full((B,), 1), c_used=full((B,), 0))
    rows = torch.arange(B, device=device)
    slots = torch.arange(W, device=device)
    discount = discount_table(gamma, H, device)
    g32 = torch.tensor(np.float32(gamma), device=device)
    draws = _Draws(noise, generator, B, H, A, W, device)
    budget_left = full((B,), budget)

    for episode in range(max_episodes):
        if episode and not bool((budget_left > 0).any()):
            draws.skip(max_episodes - episode)
            break
        active = budget_left > 0
        # ---- uniform rollout, recording the visited chain
        actions, env_noise = draws.rollout()
        state = states0
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        lives, rewards, keys = [], [], []
        for h in range(H):
            out = env.step(params, state, actions[:, h], generator,
                           None if env_noise is None else env_noise[:, h])
            lives.append(~terminal)
            rewards.append(out.reward.to(f32))
            keys.append(obs_key(out.obs))
            state = out.state
            terminal = terminal | out.terminated
        steps_used = torch.stack(lives).sum(dim=0)
        # the live steps of a rollout are a prefix: past the longest one of
        # an active tree nothing is written (one read-back an episode)
        depth = int(torch.where(active, steps_used, 0).max())

        # ---- build or look up the node chain (reference: brue.py:93-96, 113-116)
        node = torch.zeros(B, dtype=torch.int64, device=device)
        path = []
        for h in range(depth):
            live = lives[h] & active
            a = actions[:, h]
            existing = tree.d_children[rows, node, a]
            is_new = live & (existing < 0)
            new_chance = tree.c_used.clone()
            chance = torch.where(existing < 0, new_chance, existing)
            _put(tree.d_children, (rows, node, a), is_new, new_chance)
            tree.c_used.add_(is_new)
            chance = torch.where(live, chance, 0).clamp(max=Nc - 1)

            key = keys[h]
            n = tree.c_n_children[rows, chance]
            match = (tree.c_child_keys[rows, chance] == key[:, None]) & (slots < n[:, None])
            exists = match.any(dim=1)
            slot = torch.where(exists, match.to(torch.int64).argmax(dim=1), n.clamp(max=W - 1))
            insert = live & ~exists & (n < W)
            new_id = tree.d_used.clone()
            child = torch.where(insert, new_id, tree.c_children[rows, chance, slot])
            _put(tree.c_child_keys, (rows, chance, slot), insert, key)
            _put(tree.c_children, (rows, chance, slot), insert, new_id)
            tree.c_n_children[rows, chance] += insert
            d_new = new_id.clamp(max=Nd - 1)
            _put(tree.d_depth, (rows, d_new), insert, torch.full_like(new_id, h + 1))
            tree.d_used.add_(insert)
            nxt = torch.where(live, child, node)
            path.append((chance, nxt, live))
            node = nxt

        # ---- reversed update (reference: brue.py:47-51)
        for hh in reversed(range(depth)):
            chance, nxt, live = path[hh]
            r = rewards[hh]
            at = nxt.clamp(min=0)
            cnt = tree.d_count[rows, at] + 1
            _put(tree.d_count, (rows, at), live, cnt)
            _put(tree.d_reward, (rows, at), live, _running_mean(tree.d_reward[rows, at], r, cnt))
            # the walk starts at depth hh + 1 of a tree H deep: it moves at
            # most H - hh - 1 times (JAX scans H steps, the rest stand still)
            est = fma(g32, _estimate(tree, rows, at, draws.estimate(live), discount, H - hh - 1),
                      r)
            ccnt = tree.c_count[rows, chance] + 1
            _put(tree.c_count, (rows, chance), live, ccnt)
            _put(tree.c_value, (rows, chance), live,
                 _running_mean(tree.c_value[rows, chance], est, ccnt))

        budget_left = budget_left - torch.where(active, steps_used.clamp(min=1), 0)

    # recommendation: the best chance value at the root (reference: brue.py:88-91)
    ch = tree.d_children[:, 0]
    valid = ch >= 0
    vals = torch.where(valid, tree.c_value.gather(1, ch.clamp(min=0)), -torch.inf)
    ties = valid & (vals == vals.amax(dim=1, keepdim=True))
    action = (torch.where(ties, 0.0, -torch.inf) + draws.final()).argmax(dim=1)
    return action, tree


class BRUEAgent(AbstractTreeSearchAgent):
    """(reference: brue.py:119-123), planning one tree (B = 1)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({"budget": 100, "max_next_states_count": 8})
        return config

    def make_planner(self):
        budget = max(self.env.action_space.n, self.config["budget"])
        self.config["episodes"], self.config["horizon"] = allocation(budget, self.config["gamma"])

    def planner_plan(self, env, observation):
        functional = env.functional
        action, tree = brue_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n, budget=int(self.config["budget"]),
            horizon=int(self.config["horizon"]), gamma=float(self.config["gamma"]),
            width=int(self.config["max_next_states_count"]), device=self.device)
        self.last_plan_data = tree
        return [int(action[0])]
