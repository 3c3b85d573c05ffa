"""Stochastic graph-based optimistic planning (GBOP) with KL confidence sets,
batch-first.

Port of ``rl_agents_tpu/agents/tree_search/graph_based_stochastic.py``
(reference: tree_search/graph_based_stochastic.py:15-361): decision nodes
aggregated by observation; per-(s, a, s') reward KL bounds
(graph_based_stochastic.py:68-84); chance-node backups solve the constrained
max-expectation over the empirical next-state distribution for both value
bounds (graph_based_stochastic.py:167-198), with unobserved next-state slots
acting as placeholders bounded by ``max_next_states_count``
(graph_based_stochastic.py:146-150). After each sampling episode the value
bounds are tightened by masked Bellman sweeps over all visited nodes.

Every arena field carries a leading tree axis B and rows are indexed directly.
Both KL bounds of a step (upper and lower) come from one ``kl_bounds_pair_``
call at the B visited (node, action, next state) entries: on a CUDA device
one launch per (episode, depth) step, ``episodes * horizon`` a plan. It cannot
wait for the episode's end, as MDP-GapE's does: the graph merges nodes by
observation, so a walk can come back to an entry within one episode, and the
next step's optimistic choice reads ``sa_mu_ucb``. A tree whose sweeps
converged freezes under a mask while the others go on; the host reads the
number of trees still sweeping once per sweep, and the Newton solve of the
constrained expectation (next-state width above 1) reads back once per block
of trips.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import allocation
from rl_agents_torch.agents.tree_search.graph_based import GraphBasedPlannerAgent
from rl_agents_torch.agents.tree_search.olop import parse_threshold
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key, table_init, table_lookup_or_insert
from rl_agents_torch.ops.kl_bound import kl_bounds_pair_
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, max_expectation_under_constraint
from rl_agents_torch.utils.noise import gumbel, noise_tensor


class StochasticGraph(NamedTuple):
    table: Any          # HashTable [B, T]: obs key -> node id
    visited: Any        # [B, N] bool: node has sampled actions
    value_lower: Any    # [B, N] f32
    value_upper: Any    # [B, N] f32
    n_count: Any        # [B, N] i64 N(s)
    c_count: Any        # [B, N, A] i64 N(s, a)
    sa_count: Any       # [B, N, A, W] i64 N(s, a, s')
    sa_cum_reward: Any  # [B, N, A, W] f32
    sa_mu_ucb: Any      # [B, N, A, W] f32
    sa_mu_lcb: Any      # [B, N, A, W] f32
    sa_keys: Any        # [B, N, A, W] i64 holding 32-bit obs keys
    sa_child: Any       # [B, N, A, W] i64, -1 when unfilled
    sa_n: Any           # [B, N, A] i64 slots filled
    states: Any         # state NamedTuple stacked as [B, N, ...]
    used: Any           # [B] i64


def gbop_stochastic_plan(env: FunctionalEnv, params, states0, obs0,
                         generator: torch.Generator | None, num_actions: int, episodes: int,
                         horizon: int, gamma: float, accuracy: float,
                         reward_threshold_coeff: float, transition_threshold_coeff: float,
                         width: int = 1, vi_sweeps: int = 20, noise=None, env_noise=None,
                         device="cuda"):
    """Plan B graphs at once from ``states0`` (a state NamedTuple with a
    leading batch dim) and their observations ``obs0 [B, ...]``. Returns
    ``(action [B], StochasticGraph)``.

    ``noise`` is a pair of Gumbel tensors: ``[episodes, H, B, A]``, which
    breaks the ties of each step's optimistic action, and ``[B, A]``, which
    breaks those of the final conservative choice at the root. ``env_noise``
    is the env's own noise for every step, ``[episodes, H, B, ...]``. What is
    not given is drawn from ``generator``.

    ``gbop_stochastic_plan.vi_calls``, ``.vi_sweeps`` and ``.vi_tree_sweeps``
    count the value-iteration calls, the sweeps they ran (all trees together,
    until the last one stopped) and the sweeps summed over the trees that
    still needed them.
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    obs0 = torch.as_tensor(obs0).to(device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    N = 2 + E * H
    i64, f32 = torch.int64, torch.float32
    g32 = np.float32(gamma)
    gamma = torch.tensor(g32, device=device)
    vmax = torch.tensor(np.float32(1) / (np.float32(1) - g32), device=device)
    # coefficient * log(episodes) in float32, on the host: one value on every device
    log_time = np.log(np.float32(E))
    reward_threshold = torch.tensor(np.float32(reward_threshold_coeff) * log_time, device=device)
    transition_threshold = torch.tensor(np.float32(transition_threshold_coeff) * log_time,
                                        device=device)
    if noise is not None:
        action_noise, final_noise = (noise_tensor(n, device) for n in noise)
    elif generator is None:
        raise ValueError("gbop_stochastic_plan needs a generator or noise")
    if env_noise is not None:
        env_noise = noise_tensor(env_noise, device)
    rows = torch.arange(B, device=device)
    slots_w = torch.arange(W, device=device)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    def arena_of(x):
        arena = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=device)
        arena[:, 0] = x
        return arena

    table, _, _ = table_lookup_or_insert(table_init(2 * N, B, device), obs_key(obs0),
                                         full((B,), 0, i64))
    visited = full((B, N), False, torch.bool)
    value_lower = full((B, N), 0.0, f32)
    value_upper = vmax.expand(B, N).clone()
    n_count = full((B, N), 0, i64)
    c_count = full((B, N, A), 0, i64)
    sa_count = full((B, N, A, W), 0, i64)
    sa_cum_reward = full((B, N, A, W), 0.0, f32)
    sa_mu_ucb = full((B, N, A, W), 1.0, f32)
    sa_mu_lcb = full((B, N, A, W), 0.0, f32)
    sa_keys = full((B, N, A, W), 0, i64)
    sa_child = full((B, N, A, W), -1, i64)
    sa_n = full((B, N, A), 0, i64)
    states = type(states0)(*(arena_of(x) for x in states0))
    used = full((B,), 1, i64)

    def q_from_rows(c_cnt, child, count, mu_ucb, mu_lcb, v_upper, v_lower):
        """Constrained-expectation backup over leading dims ``[B, ...]``
        (graph_based_stochastic.py:167-198): rows ``[B, ..., W]``, counts
        ``[B, ...]``, values ``[B, N]``. Returns ``(q_up, q_lo) [B, ...]``."""
        cnt = c_cnt.to(f32)
        filled = child >= 0
        index = child.clamp(min=0).reshape(B, -1)
        v_up = torch.where(filled, v_upper.gather(1, index).reshape(child.shape), vmax)
        v_lo = torch.where(filled, v_lower.gather(1, index).reshape(child.shape), 0.0)
        # mu + gamma * v compiles to a fused multiply-add in the JAX package
        u_next = fma(gamma, v_up, mu_ucb)
        l_next = fma(gamma, v_lo, mu_lcb)
        safe = torch.clamp(cnt, min=1.0)
        p_hat = count.to(f32) / safe[..., None]
        threshold = transition_threshold / safe
        # the optimistic and the pessimistic problem in one solve
        p = max_expectation_under_constraint(
            torch.cat([u_next, -l_next]), torch.cat([p_hat, p_hat]),
            torch.cat([threshold, threshold]))
        q_up = torch.where(cnt > 0, (p[:B] * u_next).sum(dim=-1), vmax)
        q_lo = torch.where(cnt > 0, (p[B:] * l_next).sum(dim=-1), 0.0)
        return q_up, q_lo

    def all_q_bounds(v_upper, v_lower):
        return q_from_rows(c_count, sa_child, sa_count, sa_mu_ucb, sa_mu_lcb, v_upper, v_lower)

    def value_iteration(lo, hi):
        """Masked dense Bellman sweeps (the reference's matrix VI form), each
        tree until its residual is at most ``accuracy``."""
        active = torch.ones(B, dtype=torch.bool, device=device)
        n_active = B
        gbop_stochastic_plan.vi_calls += 1
        for _ in range(vi_sweeps):
            q_up, q_lo = all_q_bounds(hi, lo)
            new_hi = torch.where(visited, q_up.amax(dim=2), hi)
            new_lo = torch.where(visited, q_lo.amax(dim=2), lo)
            delta = torch.maximum((new_lo - lo).abs().amax(dim=1), (new_hi - hi).abs().amax(dim=1))
            lo = torch.where(active[:, None], new_lo, lo)
            hi = torch.where(active[:, None], new_hi, hi)
            active = active & (delta > accuracy)
            gbop_stochastic_plan.vi_sweeps += 1
            gbop_stochastic_plan.vi_tree_sweeps += n_active
            n_active = int(active.sum())
            if n_active == 0:
                break
        return lo, hi

    def register(table, used, key, state):
        """Look ``key [B]`` up in each tree's node table, or insert it at
        ``used`` with its env state. A full table's -1 is clamped to node 0,
        as in the JAX package; the table is sized so that it never fills."""
        table, node, is_new = table_lookup_or_insert(table, key, used)
        at = used.clamp(max=N - 1)
        for arena, value in zip(states, state):
            mask = is_new.reshape((B,) + (1,) * (value.dim() - 1))
            arena[rows, at] = torch.where(mask, value, arena[rows, at])
        return table, used + is_new, node.clamp(min=0)

    for episode in range(E):
        g = action_noise[episode] if noise is not None else gumbel((H, B, A), generator, device)
        state, obs = states0, obs0
        for h in range(H):
            table, used, node = register(table, used, obs_key(obs), state)

            # optimistic sampling (graph_based_stochastic.py:42-51)
            q_up = q_from_rows(c_count[rows, node], sa_child[rows, node], sa_count[rows, node],
                               sa_mu_ucb[rows, node], sa_mu_lcb[rows, node],
                               value_upper, value_lower)[0]
            ties = q_up == q_up.amax(dim=1, keepdim=True)
            action = (torch.where(ties, 0.0, -torch.inf) + g[h]).argmax(dim=1)
            out = env.step(params, state, action, generator,
                           None if env_noise is None else env_noise[episode, h])

            # next-state slot (graph_based_stochastic.py:207-219); past the
            # last slot a new next state overwrites slot W - 1
            nkey = obs_key(out.obs)
            nslots = sa_n[rows, node, action]
            match = (sa_keys[rows, node, action] == nkey[:, None]) & (slots_w < nslots[:, None])
            exists = match.any(dim=1)
            insert = ~exists & (nslots < W)
            slot = torch.where(exists, match.to(torch.int8).argmax(dim=1),
                               nslots.clamp(max=W - 1))

            # register the next decision node globally
            table, used, next_node = register(table, used, nkey, out.state)

            # statistics updates (graph_based_stochastic.py:253-258)
            at = (rows, node, action, slot)
            cnt = sa_count[at] + 1
            cum = sa_cum_reward[at] + out.reward.to(f32)
            visited[rows, node] = True
            n_count[rows, node] += 1
            c_count[rows, node, action] += 1
            sa_keys[at] = torch.where(insert, nkey, sa_keys[at])
            sa_child[at] = next_node
            sa_n[rows, node, action] += insert
            sa_count[at] = cnt
            sa_cum_reward[at] = cum
            # both bounds of the entry, at its offset (node * A + action) * W + slot
            # in the tree's [N, A, W] row
            offset = torch.add(slot, torch.add(action, node, alpha=A), alpha=W)
            kl_bounds_pair_(sa_mu_ucb, sa_mu_lcb, sa_cum_reward, sa_count, offset,
                            reward_threshold)
            state, obs = out.state, out.obs
        value_lower, value_upper = value_iteration(value_lower, value_upper)

    if int(used.max()) > N:
        raise AssertionError(f"a graph allocated {int(used.max())} nodes in an arena of {N}")
    # conservative plan at the root (graph_based.py:126-135 semantics)
    root_q = all_q_bounds(value_upper, value_lower)[1][:, 0]
    ties = root_q == root_q.amax(dim=1, keepdim=True)
    g = final_noise if noise is not None else gumbel((B, A), generator, device)
    action = (torch.where(ties, 0.0, -torch.inf) + g).argmax(dim=1)
    graph = StochasticGraph(
        table=table, visited=visited, value_lower=value_lower, value_upper=value_upper,
        n_count=n_count, c_count=c_count, sa_count=sa_count, sa_cum_reward=sa_cum_reward,
        sa_mu_ucb=sa_mu_ucb, sa_mu_lcb=sa_mu_lcb, sa_keys=sa_keys, sa_child=sa_child, sa_n=sa_n,
        states=states, used=used)
    return action, graph


gbop_stochastic_plan.vi_calls = gbop_stochastic_plan.vi_sweeps = 0
gbop_stochastic_plan.vi_tree_sweeps = 0


class StochasticGraphBasedPlannerAgent(GraphBasedPlannerAgent):
    """(reference: graph_based_stochastic.py:346-361)"""

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "max_next_states_count": 1,
            "upper_bound": {
                "type": "kullback-leibler",
                "time": "global",
                "threshold": "1*np.log(time)",
                "transition_threshold": "0.1*np.log(time)",
            },
        })
        return cfg

    def make_planner(self):
        budget = max(self.env.action_space.n, self.config["budget"])
        self.config["episodes"], self.config["horizon"] = allocation(
            budget, self.config["gamma"])

    def planner_plan(self, env, observation):
        functional = env.functional
        ub = self.config["upper_bound"]
        action, graph = gbop_stochastic_plan(
            functional, env.params, env.state, functional.observe(env.params, env.state),
            self.generator, num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]), accuracy=float(self.config["accuracy"]),
            reward_threshold_coeff=parse_threshold(ub.get("threshold", 1.0)),
            transition_threshold_coeff=parse_threshold(ub.get("transition_threshold", 0.1)),
            width=max(int(self.config["max_next_states_count"]), 1), device=self.device)
        self.last_plan_data = graph
        return [int(action[0])]
