"""MCTS with Double Progressive Widening, batch-first over trees.

Port of ``rl_agents_tpu/agents/tree_search/mcts_dpw.py`` (reference:
tree_search/mcts_dpw.py:29-193): UCT where both the action set and the
observed-outcome set of a node are widened progressively. A new action child
is inserted only while ``k_action * count ** alpha_action`` reaches the number
of children (mcts_dpw.py:120-127), a new outcome child only while
``k_state * count ** alpha_state`` does (mcts_dpw.py:171-182); outcomes are
told apart by observation keys (``ops/hashing.py::obs_key``) in ``width``
slots per chance node. Decision and chance arenas alternate.

Every arena field carries a leading tree axis B; rows are indexed directly.
The descent is at most ``horizon`` masked steps, the backup at most
``horizon + 1``. The widening thresholds ``k * n ** alpha`` are float32 host
tables over the possible counts, made with scalar correctly rounded ``powf``
as XLA rounds its ``pow``, so that a child is never inserted one visit early
or late.

Randomness (``DPWNoise``): Gumbel noise for the new action, the UCB ties and
the rollout actions, a random existing slot for each possible number of
slots, and the env's own step noise; injected by the caller so that a test
can replay the JAX package's draws, or drawn from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.mcts import (
    MCTSAgent,
    _masked_random_argmax,
    _where_state,
    discount_table,
)
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import gumbel, noise_tensor, uniform


class DPWTree(NamedTuple):
    # decision nodes
    d_parent: Any      # [B, Nd] i64 chance parent
    d_count: Any       # [B, Nd] i64
    d_value: Any       # [B, Nd] f32
    d_children: Any    # [B, Nd, A] i64 chance ids (per action)
    d_n_children: Any  # [B, Nd] i64
    # chance nodes
    c_parent: Any      # [B, Nc] i64 decision parent
    c_action: Any      # [B, Nc] i64
    c_count: Any       # [B, Nc] i64
    c_value: Any       # [B, Nc] f32
    c_child_keys: Any  # [B, Nc, W] i64 observation keys
    c_children: Any    # [B, Nc, W] i64 decision ids
    c_n_children: Any  # [B, Nc] i64
    d_used: Any        # [B] i64
    c_used: Any        # [B] i64


class DPWNoise(NamedTuple):
    """The random inputs of ``episodes`` episodes of B trees, each indexed
    ``[episode, step, tree]``: ``expand`` and ``select`` ``[E, H, B, A]``
    Gumbel draws for the widened action and the UCB ties of the descent step
    (``expand`` is None for closed-loop MCTS), ``slot [E, H, B, W]`` the random
    existing slot drawn when an outcome is neither found nor inserted (entry
    ``n - 1`` when the node has ``n`` slots), ``env`` the env's noise of the
    descent step, ``rollout [E, H, B, A]`` the Gumbel draw of each rollout
    action and ``rollout_env`` the env's noise of that step. An env noise is
    None for an env that draws nothing."""

    expand: Any
    select: Any
    slot: Any
    env: Any
    rollout: Any
    rollout_env: Any


def widening_table(k: float, alpha: float, size: int, device) -> torch.Tensor:
    """``k * n ** alpha`` for n < size in float32, with scalar correctly
    rounded ``powf`` as XLA's ``pow`` rounds (vectorised pows do not always)."""
    k32, a32 = np.float32(k), np.float32(alpha)
    return torch.tensor([k32 * (np.float32(n) ** a32) for n in range(size)],
                        dtype=torch.float32, device=device)


def init_dpw_tree(batch: int, nd: int, nc: int, num_actions: int, width: int,
                  device) -> DPWTree:
    B, A, W = batch, num_actions, width

    def full(shape, fill, dtype=torch.int64):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return DPWTree(
        d_parent=full((B, nd), -1), d_count=full((B, nd), 0),
        d_value=full((B, nd), 0.0, torch.float32), d_children=full((B, nd, A), -1),
        d_n_children=full((B, nd), 0),
        c_parent=full((B, nc), -1), c_action=full((B, nc), -1), c_count=full((B, nc), 0),
        c_value=full((B, nc), 0.0, torch.float32), c_child_keys=full((B, nc, W), 0),
        c_children=full((B, nc, W), -1), c_n_children=full((B, nc), 0),
        d_used=full((B,), 1), c_used=full((B,), 0))


def _put(x, index, mask, value):
    """``x[index] = value`` where ``mask``, the old value elsewhere."""
    x[index] = torch.where(mask, value, x[index])


def draw_noise(generator, batch: int, horizon: int, num_actions: int, width: int, device,
               expand: bool = True) -> DPWNoise:
    """One episode's ``DPWNoise`` entries (no episode axis), drawn from
    ``generator``; the slot draw for ``n`` slots is ``floor(u * n)``. The env
    noises are None: the env draws from ``generator`` itself."""
    H, B, A, W = horizon, batch, num_actions, width
    g = gumbel((3 if expand else 2, H, B, A), generator, device)
    u = uniform((H, B, 1), generator, device)
    slot = torch.floor(u * torch.arange(1, W + 1, device=device)).to(torch.int64)
    return DPWNoise(expand=g[2] if expand else None, select=g[0], slot=slot, env=None,
                    rollout=g[1], rollout_env=None)


def episode_noise(noise: DPWNoise | None, episode: int, generator, batch, horizon, num_actions,
                  width, device, expand: bool = True) -> DPWNoise:
    """The draws of one episode: the injected ones, or fresh ones."""
    if noise is None:
        if generator is None:
            raise ValueError("the planner needs a generator or noise")
        return draw_noise(generator, batch, horizon, num_actions, width, device, expand)

    def at(x, dtype=None):
        if x is None:
            return None
        x = x[episode]
        if dtype is not None:
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            return x.to(device=device, dtype=dtype)
        return noise_tensor(x, device)

    return DPWNoise(expand=at(noise.expand), select=at(noise.select),
                    slot=at(noise.slot, torch.int64), env=at(noise.env),
                    rollout=at(noise.rollout), rollout_env=at(noise.rollout_env))


def chance_child(tree: DPWTree, rows, chance, key, can_widen, slot_draw, active):
    """The decision child of ``chance [B]`` for the outcome ``key [B]``
    (reference: mcts_dpw.py:168-182, mcts.py:267-273): the matching slot if
    the key is there, a new child if ``can_widen``, else the slot that
    ``slot_draw [B, W]`` picks among the ``n`` present. Writes where
    ``active``. Returns the child ids ``[B]``."""
    W = tree.c_children.shape[2]
    slots = torch.arange(W, device=chance.device)
    keys_row = tree.c_child_keys[rows, chance]
    n = tree.c_n_children[rows, chance]
    match = (keys_row == key[:, None]) & (slots < n[:, None])
    exists = match.any(dim=1)
    random_slot = slot_draw.gather(1, (n.clamp(min=1) - 1)[:, None]).squeeze(1)
    new_decision = tree.d_used.clone()
    insert = active & ~exists & can_widen
    slot = torch.where(exists, match.to(torch.int64).argmax(dim=1),
                       torch.where(insert, n, random_slot)).clamp(max=W - 1)
    child = torch.where(insert, new_decision, tree.c_children[rows, chance, slot])
    _put(tree.c_child_keys, (rows, chance, slot), insert, key)
    _put(tree.c_children, (rows, chance, slot), insert, new_decision)
    tree.c_n_children[rows, chance] += insert
    d_new = new_decision.clamp(max=tree.d_parent.shape[1] - 1)
    _put(tree.d_parent, (rows, d_new), insert, chance)
    tree.d_used.add_(insert)
    return child


def rollout(env, params, state, depth, total, terminal, noise: DPWNoise, rollout_logits,
            discount, horizon: int, generator):
    """Random rollout to the horizon (reference: mcts.py:160-177): returns
    the total where the descent ended in a non-terminal state."""
    f32 = torch.float32
    h, rolled, roll_terminal = depth, total, terminal
    for step in range(horizon):
        action = (rollout_logits + noise.rollout[step]).argmax(dim=1)
        env_noise = None if noise.rollout_env is None else noise.rollout_env[step]
        out = env.transition(params, state, action, generator, env_noise)
        live = (h < horizon) & ~roll_terminal
        rolled = rolled + torch.where(live, discount[h] * out.reward.to(f32), 0.0)
        state = _where_state(live, out.state, state)
        roll_terminal = roll_terminal | (live & out.terminated)
        h = h + 1
    return torch.where(terminal, total, rolled)


def backup(tree: DPWTree, rows, node, total, horizon: int):
    """Back ``total`` up the alternating decision/chance path from ``node``
    (reference: mcts_dpw.py:129-137,184-193), at most ``horizon + 1``
    decision nodes."""
    f32 = torch.float32
    n = node
    for _ in range(horizon + 1):
        on_path = n >= 0
        at = n.clamp(min=0)
        cnt = tree.d_count[rows, at] + 1
        old = tree.d_value[rows, at]
        _put(tree.d_count, (rows, at), on_path, cnt)
        _put(tree.d_value, (rows, at), on_path, old + (total - old) / cnt.to(f32))
        chance = torch.where(on_path, tree.d_parent[rows, at], -1)
        has = chance >= 0
        c_at = chance.clamp(min=0)
        c_cnt = tree.c_count[rows, c_at] + 1
        c_old = tree.c_value[rows, c_at]
        _put(tree.c_count, (rows, c_at), has, c_cnt)
        _put(tree.c_value, (rows, c_at), has, c_old + (total - c_old) / c_cnt.to(f32))
        n = torch.where(has, tree.c_parent[rows, c_at], -1)


def root_action(tree: DPWTree):
    """The root's selection rule (reference: mcts_dpw.py:92-94): the most
    visited action, ties by value, the first of equals."""
    ch = tree.d_children[:, 0]
    valid = ch >= 0
    chs = ch.clamp(min=0)
    counts = torch.where(valid, tree.c_count.gather(1, chs), -1)
    tie = valid & (counts == counts.amax(dim=1, keepdim=True))
    return torch.where(tie, tree.c_value.gather(1, chs), -torch.inf).argmax(dim=1)


def mcts_dpw_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                  rollout_probs, num_actions: int, episodes: int, horizon: int, gamma: float,
                  temperature: float, k_action: float, alpha_action: float, k_state: float,
                  alpha_state: float, width: int = 8, closed_loop: bool = True,
                  noise: DPWNoise | None = None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a
    leading batch dim). Returns ``(action [B], DPWTree)``. ``noise`` holds
    the draws of every episode (``DPWNoise``, leading axis ``episodes``);
    without it they are drawn from ``generator``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    f32 = torch.float32
    Nd = Nc = 1 + E * H
    tree = init_dpw_tree(B, Nd, Nc, A, W, device)
    rows = torch.arange(B, device=device)
    discount = discount_table(gamma, 2 * H, device)
    widen_action = widening_table(k_action, alpha_action, E + 2, device)
    widen_state = widening_table(k_state, alpha_state, E + 2, device)
    temperature = torch.tensor(temperature, dtype=f32, device=device)
    rollout_logits = torch.log(torch.as_tensor(rollout_probs, dtype=f32).to(device))
    one_key = torch.ones(B, dtype=torch.int64, device=device)

    for episode in range(E):
        draws = episode_noise(noise, episode, generator, B, H, A, W, device)
        node = torch.zeros(B, dtype=torch.int64, device=device)
        depth = torch.zeros(B, dtype=torch.int64, device=device)
        total = torch.zeros(B, dtype=f32, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        state = states0
        for step in range(H):
            visited = (tree.d_count[rows, node] != 0) | (node == 0)
            active = (depth < H) & ~terminal & visited
            # ---- action progressive widening (reference: mcts_dpw.py:106-127,139-154)
            n_children = tree.d_n_children[rows, node]
            count = tree.d_count[rows, node]
            widen = active & (n_children < A) & (widen_action[count] >= n_children.to(f32))
            ch = tree.d_children[rows, node]
            explored = ch >= 0
            chs = ch.clamp(min=0)
            new_action = (torch.where(explored, -torch.inf, 0.0) + draws.expand[step]).argmax(dim=1)
            c_count = torch.clamp(tree.c_count.gather(1, chs).to(f32), min=1e-6)
            c_value = torch.where(explored, tree.c_value.gather(1, chs), 0.0)
            ucb = c_value + temperature * torch.sqrt(
                torch.log(torch.clamp(count.to(f32)[:, None] / c_count, min=1.0)))
            sel_action = _masked_random_argmax(draws.select[step], ucb, explored)
            action = torch.where(widen, new_action, sel_action)
            new_chance = tree.c_used.clone()
            chance = torch.where(widen, new_chance, ch.gather(1, action[:, None]).squeeze(1))
            _put(tree.d_children, (rows, node, action), widen, new_chance)
            tree.d_n_children[rows, node] += widen
            c_new = new_chance.clamp(max=Nc - 1)
            _put(tree.c_parent, (rows, c_new), widen, node)
            _put(tree.c_action, (rows, c_new), widen, action)
            tree.c_used.add_(widen)

            env_noise = None if draws.env is None else draws.env[step]
            out = env.step(params, state, action, generator, env_noise)
            # ---- state progressive widening (reference: mcts_dpw.py:168-182)
            key = obs_key(out.obs) if closed_loop else one_key
            chance = chance.clamp(min=0)
            c_n = tree.c_n_children[rows, chance]
            c_cnt = tree.c_count[rows, chance]
            can_widen = (c_n < W) & (widen_state[c_cnt] >= c_n.to(f32))
            child = chance_child(tree, rows, chance, key, can_widen, draws.slot[step], active)
            # total + gamma ** depth * reward is one fused multiply-add in the JAX package
            new_total = fma(discount[depth], out.reward.to(f32), total)
            node = torch.where(active, child, node)
            state = _where_state(active, out.state, state)
            total = torch.where(active, new_total, total)
            terminal = terminal | (active & out.terminated)
            depth = depth + active

        total = rollout(env, params, state, depth, total, terminal, draws, rollout_logits,
                        discount, H, generator)
        backup(tree, rows, node, total, H)

    return root_action(tree), tree


class MCTSDPWAgent(MCTSAgent):
    """(reference: mcts_dpw.py:10-27), planning one tree (B = 1)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({
            "budget": 100,
            "gamma": 0.95,
            "temperature": 1.0,
            "closed_loop": True,
            "k_state": 1.0,
            "alpha_state": 0.3,
            "k_action": 3.0,
            "alpha_action": 0.3,
            "max_next_states_count": 8,
        })
        return config

    def planner_plan(self, env, observation):
        functional = env.functional
        action, tree = mcts_dpw_plan(
            functional, env.params, env.state, self.generator, self.rollout_probs,
            num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]), temperature=float(self.config["temperature"]),
            k_action=float(self.config["k_action"]),
            alpha_action=float(self.config["alpha_action"]),
            k_state=float(self.config["k_state"]), alpha_state=float(self.config["alpha_state"]),
            width=int(self.config["max_next_states_count"]),
            closed_loop=bool(self.config["closed_loop"]), device=self.device)
        self.last_plan_data = tree
        return [int(action[0])]

    def planner_step_tree(self, actions):
        pass
