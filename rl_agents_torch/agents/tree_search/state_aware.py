"""State-aware optimistic planning (OPD + state aggregation), batch-first.

Port of ``rl_agents_tpu/agents/tree_search/state_aware.py`` (reference:
tree_search/state_aware.py:10-137): OPD where all tree nodes observing the same
state share a global state-value upper-confidence bound
(state_aware.py:74-86, the ``state_values`` dict; here a hash table and a
value array per tree). A node's UCB is
``value_lower + gamma^depth * state_value[obs]`` (state_aware.py:66-68). The
reference's queue backup through aggregated neighbours (state_aware.py:43-64)
is a fixed number of global tightening sweeps: candidate bounds are
scatter-min'd into the state-value array.

Every arena field carries a leading tree axis B and rows are indexed directly.
Nothing in a plan reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.deterministic import (
    DeterministicPlannerAgent,
    _greedy_plan,
)
from rl_agents_torch.agents.tree_search.mcts import discount_table
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key, table_init, table_lookup_or_insert
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import noise_tensor


class StateAwareTree(NamedTuple):
    parent: Any        # [B, N] i64
    action: Any        # [B, N] i64
    depth: Any         # [B, N] i64
    children: Any      # [B, N, A] i64
    reward: Any        # [B, N] f32
    done: Any          # [B, N] bool
    value_lower: Any   # [B, N] f32
    leaf: Any          # [B, N] bool
    obs_id: Any        # [B, N] i64 index into the state-value array
    used: Any          # [B] i64
    states: Any        # state NamedTuple stacked as [B, N, ...]
    # global state aggregation
    table: Any         # HashTable [B, T]: obs key -> state id
    state_values: Any  # [B, S] f32 state-value UCBs


def state_aware_plan(env: FunctionalEnv, params, states0, obs0,
                     generator: torch.Generator | None, num_actions: int, expansions: int,
                     gamma: float, terminal_reward: float = 0.0, plan_capacity: int = 32,
                     vi_sweeps: int = 10, noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim) and their observations ``obs0 [B, ...]``. Returns
    ``(actions [B, P] with -1 past the plan, lengths [B], StateAwareTree)``.

    ``noise`` is Gumbel noise ``[plan_capacity, B, A]`` that breaks the ties of
    the plan's descent; without it, it is drawn from ``generator``.
    """
    device = resolve_device(device)
    if noise is None and generator is None:
        raise ValueError("state_aware_plan needs a generator or noise")
    params = params_to(params, device)
    states0 = params_to(states0, device)
    obs0 = torch.as_tensor(obs0).to(device)
    A = num_actions
    B = states0[0].shape[0]
    N = 1 + expansions * A
    S = N  # at most one distinct state per node
    i64, f32 = torch.int64, torch.float32
    g32 = np.float32(gamma)
    gamma = torch.tensor(g32, device=device)
    one_minus_gamma = torch.tensor(np.float32(1) - g32, device=device)
    vmax = torch.tensor(np.float32(1) / (np.float32(1) - g32), device=device)
    terminal_reward = torch.tensor(np.float32(terminal_reward), device=device)
    discount = discount_table(g32, N + 1, device)
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    actions_rep = offsets.repeat(B)
    null_noise = env.null_noise(B * A, device)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    def arena_of(x):
        arena = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=device)
        arena[:, 0] = x
        return arena

    table, _, _ = table_lookup_or_insert(table_init(2 * S, B, device), obs_key(obs0),
                                         full((B,), 0, i64))
    parent, action_from = full((B, N), -1, i64), full((B, N), -1, i64)
    depth, children = full((B, N), 0, i64), full((B, N, A), -1, i64)
    reward, done = full((B, N), 0.0, f32), full((B, N), False, torch.bool)
    value_lower, leaf = full((B, N), 0.0, f32), full((B, N), False, torch.bool)
    leaf[:, 0] = True
    obs_id = full((B, N), 0, i64)
    states = type(states0)(*(arena_of(x) for x in states0))
    state_values = vmax.expand(B, S).clone()

    def expand(leaf_idx, base: int, table, state_values):
        """Expand the leaf ``leaf_idx [B]`` into the child block at rows
        ``base .. base + A``, and register each child's observation in the
        tree's state table, in action order."""
        block = slice(base, base + A)
        leaf_state = type(states0)(*(x[rows, leaf_idx].repeat_interleave(A, dim=0)
                                     for x in states))
        out = env.step(params, leaf_state, actions_rep, None, null_noise)
        d = depth[rows, leaf_idx] + 1
        r = out.reward.to(f32).reshape(B, A)
        child_done = out.terminated.reshape(B, A) | done[rows, leaf_idx][:, None]
        # value_lower + gamma ** (d - 1) * reward: one fused multiply-add in the JAX package
        vl = fma(discount[d - 1][:, None], r, value_lower[rows, leaf_idx][:, None])
        vl = torch.where(
            child_done, vl + terminal_reward * discount[d][:, None] / one_minus_gamma, vl)

        okeys = obs_key(out.obs).reshape(B, A)
        for a in range(A):
            table, sid, _ = table_lookup_or_insert(table, okeys[:, a], table.count)
            # terminal states have zero value-to-go (state_aware.py:24-26)
            at = sid.clamp(min=0)
            state_values[rows, at] = torch.where(child_done[:, a] & (sid >= 0), 0.0,
                                                 state_values[rows, at])
            obs_id[:, base + a] = sid

        for arena, new in zip(states, out.state):
            arena[:, block] = new.reshape((B, A) + new.shape[1:])
        parent[:, block] = leaf_idx[:, None]
        action_from[:, block] = offsets
        depth[:, block] = d[:, None]
        children[rows, leaf_idx] = base + offsets
        reward[:, block] = r
        done[:, block] = child_done
        value_lower[:, block] = vl
        leaf[rows, leaf_idx] = False
        leaf[:, block] = True
        return table

    def tighten(state_values):
        """Global state-value tightening sweeps (replaces the reference's
        queue backup, state_aware.py:43-64): for every expanded node, the
        candidate bound max_a [r_child + gamma * sv(obs_child)] min-reduces
        into its state's value."""
        valid = children >= 0
        cidx = children.clamp(min=0).reshape(B, N * A)
        child_reward = torch.where(valid, reward.gather(1, cidx).reshape(B, N, A), 0.0)
        child_obs = torch.where(valid, obs_id.gather(1, cidx).reshape(B, N, A), 0)
        child_obs = child_obs.reshape(B, N * A)
        expanded = valid.any(dim=2)
        for _ in range(vi_sweeps):
            sv_child = state_values.gather(1, child_obs).reshape(B, N, A)
            # r + gamma * sv: one fused multiply-add in the JAX package
            cand = torch.where(valid, fma(gamma, sv_child, child_reward), -torch.inf).amax(dim=2)
            cand = torch.where(expanded, cand, torch.inf)
            state_values = state_values.scatter_reduce(1, obs_id, cand, reduce="amin",
                                                       include_self=True)
        return state_values

    for i in range(expansions):
        # value_lower + gamma^depth * state_value (state_aware.py:66-68)
        ucb = fma(discount[depth], state_values.gather(1, obs_id), value_lower)
        leaf_idx = torch.where(leaf, ucb, -torch.inf).argmax(dim=1)
        table = expand(leaf_idx, 1 + i * A, table, state_values)
        state_values = tighten(state_values)

    tree = StateAwareTree(
        parent=parent, action=action_from, depth=depth, children=children, reward=reward,
        done=done, value_lower=value_lower, leaf=leaf, obs_id=obs_id,
        used=full((B,), N, i64), states=states, table=table, state_values=state_values)
    # plan: greedy descent by value_lower (the inherited OPD selection rule)
    actions, lengths = _greedy_plan(tree, generator, plan_capacity,
                                    None if noise is None else noise_tensor(noise, device))
    return actions, lengths, tree


class StateAwarePlannerAgent(DeterministicPlannerAgent):
    """(reference: state_aware.py:133-137)"""

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "backup_aggregated_nodes": True,
            "prune_suboptimal_leaves": True,
            "accuracy": 0,
        })
        return cfg

    def planner_plan(self, env, observation):
        functional = env.functional
        num_actions = functional.action_space.n
        expansions = max(int(self.config["budget"]) // num_actions, 1)
        actions, lengths, tree = state_aware_plan(
            functional, env.params, env.state, functional.observe(env.params, env.state),
            self.generator, num_actions=num_actions, expansions=expansions,
            gamma=float(self.config["gamma"]),
            terminal_reward=float(self.config["terminal_reward"]),
            plan_capacity=min(max(expansions, 1), 64), device=self.device)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])
