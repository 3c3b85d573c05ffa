"""Plain reference of stochastic graph-based optimistic planning (GBOP with
KL confidence sets), as eleurent/rl-agents implements it in
``agents/tree_search/graph_based_stochastic.py`` (the constrained
expectation in ``agents/common/utils.py:292-342``). Each graph
plans from its own start state; a plan runs ``episodes`` episodes of
``horizon`` steps from the root:

- decision nodes are merged by observation across the whole plan: a state
  whose observation was met before, at any depth, is that node;
- at each step the node takes its optimistic action, the largest upper
  bound ``Q+(s, a)``, ties broken at random; the env steps; the next state
  is kept in one of the action's ``width`` next-state slots, told apart by
  its observation's key: a new key takes the next free slot, and once all
  are taken, the last slot (its key kept, its node replaced by the new
  one); the slot's count and reward sum grow, and its reward mean gets its
  KL-UCB and KL-LCB, ``KL <= c / n`` at its count ``n`` with ``c`` the
  reward threshold ``1 log(episodes)`` (``upper_bound.threshold``
  ``1*np.log(time)``, ``time`` the budget's episodes);
- ``Q+(s, a) = max_p E_p[mu_ucb + gamma V+]`` and ``Q-(s, a) = min_p
  E_p[mu_lcb + gamma V-]`` over the next-state distributions ``p`` with
  ``KL(p_hat || p) <= 0.1 log(episodes) / N(s, a)``, where a slot without
  a next state has count 0, reward bounds ``[0, 1]`` and vacuous value
  bounds ``[0, 1 / (1 - gamma)]``; an action never taken has ``[0, 1 / (1 -
  gamma)]``;
- after each episode, Bellman sweeps over every visited node set ``V+ =
  max_a Q+`` and ``V- = max_a Q-`` until a sweep moves no bound of the
  graph by more than ``accuracy``, at most ``vi_sweeps`` sweeps; an
  unvisited node keeps ``[0, 1 / (1 - gamma)]``;
- the plan's action is the root's conservative one, the largest ``Q-``,
  ties broken at random.

Every random choice is an argmax over given Gumbel draws: ``noise [E, H,
B, A]`` breaks the optimistic action's ties, ``final_noise [B, A]`` the
root's; ``env_noise [E, H, B]`` is the env's uniform draw (``sailing.py``).

Three choices follow the program where the published code leaves them
open, each a layout and none a semantics. Arena: decision nodes are slots
of fixed arrays, node 0 the root, each new observation the next slot
(``2 + episodes * horizon`` of them), met first as the step's node and then
as its next state. Keys: a slot holds the key of its next state's
observation, hashed as the program hashes observations (``sailing.py``),
since the comparison is slot by slot. Constants: each ``mu + gamma v``
rounds once (``rounding.fused``), ``1 / (1 - gamma)`` and the transitions'
``0.1 log(episodes)`` are float32 operations, as the program's are; the
reward threshold is evaluated in float64 and rounded to float32 once. The
sweeps are the dense matrix form that upstream's module carries beside its
recursive backup (``graph_based_stochastic.py:272-330``), as the program
runs them.

Many graphs at once, one row each. Plain PyTorch; imports nothing of the
program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import kl
from perfbench.reference.mdp_gape import lower_bound, max_expectation
from perfbench.reference.rounding import fused


class Graph(NamedTuple):
    visited: torch.Tensor        # [B, N] bool: the node took an action
    value_lower: torch.Tensor    # [B, N] V-
    value_upper: torch.Tensor    # [B, N] V+
    n_count: torch.Tensor        # [B, N] int64 N(s)
    c_count: torch.Tensor        # [B, N, A] int64 N(s, a)
    sa_count: torch.Tensor       # [B, N, A, W] int64 N(s, a, s')
    sa_cum_reward: torch.Tensor  # [B, N, A, W] reward sum
    sa_mu_ucb: torch.Tensor      # [B, N, A, W] KL-UCB of the mean reward
    sa_mu_lcb: torch.Tensor      # [B, N, A, W] KL-LCB
    sa_keys: torch.Tensor        # [B, N, A, W] int64 the next state's observation key
    sa_child: torch.Tensor       # [B, N, A, W] int64 its node, -1 where the slot is free
    sa_n: torch.Tensor           # [B, N, A] int64 slots taken
    used: torch.Tensor           # [B] int64 nodes


def q_bounds(c_count, sa_child, sa_count, mu_ucb, mu_lcb, v_upper, v_lower, gamma, vmax,
             transition_threshold, dtype):
    """``(Q+, Q-)`` ``[B, ...]`` of (node, action) rows ``[B, ..., W]`` (their
    visits ``c_count [B, ...]``) under the value bounds ``v_upper``,
    ``v_lower`` ``[B, N]``."""
    B = c_count.shape[0]
    visits = c_count.to(dtype)
    taken = sa_child >= 0
    child = sa_child.clamp(min=0).reshape(B, -1)
    v_up = torch.where(taken, v_upper.gather(1, child).reshape(sa_child.shape), vmax)
    v_lo = torch.where(taken, v_lower.gather(1, child).reshape(sa_child.shape), 0.0)
    upper = fused(gamma, v_up, mu_ucb, dtype)
    lower = fused(gamma, v_lo, mu_lcb, dtype)
    safe = torch.clamp(visits, min=1.0)
    p_hat = sa_count.to(dtype) / safe[..., None]
    budget = transition_threshold / safe
    W = upper.shape[-1]
    rows = lambda x: x.reshape(-1, W)
    p_up = max_expectation(rows(upper), rows(p_hat), budget.reshape(-1)).reshape(upper.shape)
    p_lo = max_expectation(rows(-lower), rows(p_hat), budget.reshape(-1)).reshape(lower.shape)
    q_up = torch.where(visits > 0, (p_up * upper).sum(dim=-1), vmax)
    q_lo = torch.where(visits > 0, (p_lo * lower).sum(dim=-1), 0.0)
    return q_up, q_lo


def graph_q_bounds(t: "Graph", v_upper, v_lower, gamma, vmax, transition_threshold, dtype):
    """``(Q+, Q-)`` ``[B, N, A]`` of every (node, action) of the graphs."""
    return q_bounds(t.c_count, t.sa_child, t.sa_count, t.sa_mu_ucb, t.sa_mu_lcb, v_upper,
                    v_lower, gamma, vmax, transition_threshold, dtype)


def sweeps(t: Graph, gamma, vmax, transition_threshold, accuracy: float, vi_sweeps: int, dtype):
    """The value iteration after an episode: ``(V-, V+)`` once each graph's
    sweep moved its bounds by at most ``accuracy``, or after ``vi_sweeps``."""
    lo, hi = t.value_lower, t.value_upper
    live = torch.ones(lo.shape[0], dtype=torch.bool, device=lo.device)
    for _ in range(vi_sweeps):
        q_up, q_lo = graph_q_bounds(t, hi, lo, gamma, vmax, transition_threshold, dtype)
        new_hi = torch.where(t.visited, q_up.amax(dim=2), hi)
        new_lo = torch.where(t.visited, q_lo.amax(dim=2), lo)
        moved = torch.maximum((new_lo - lo).abs().amax(dim=1), (new_hi - hi).abs().amax(dim=1))
        lo = torch.where(live[:, None], new_lo, lo)
        hi = torch.where(live[:, None], new_hi, hi)
        live = live & (moved > accuracy)
        if not bool(live.any()):
            break
    return lo, hi


def plan(env, model, starts, noise, final_noise, env_noise, **kwargs):
    """Plan one graph from each start state (``_plan``), with TF32 off: the
    plan multiplies no matrices, so it could not enter, but a reference
    leaves no rounding to a flag."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _plan(env, model, starts, noise, final_noise, env_noise, **kwargs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _plan(env, model, starts, noise, final_noise, env_noise, *, num_actions: int, episodes: int,
          horizon: int, width: int, gamma: float, accuracy: float, reward_threshold_coeff: float,
          transition_threshold_coeff: float, vi_sweeps: int, dtype=torch.float32):
    """Plan one graph from each start state. ``env`` is the env's plain
    reference (its ``transition``, ``observation`` and
    ``observation_keys``), ``starts`` its state. Returns ``(action [B],
    Graph)``."""
    A, W, H, E = num_actions, width, horizon, episodes
    dev = starts.wind.device
    B = starts.wind.shape[0]
    N = 2 + E * H
    i64 = torch.int64
    rows = torch.arange(B, device=dev)
    g32 = np.float32(gamma)
    gamma_ = torch.tensor(g32, device=dev).to(dtype)
    vmax = torch.tensor(np.float32(1) / (np.float32(1) - g32), device=dev).to(dtype)
    reward_threshold = torch.tensor(reward_threshold_coeff * np.log(E), dtype=torch.float32,
                                    device=dev).to(dtype)
    transition_threshold = torch.tensor(np.float32(transition_threshold_coeff)
                                        * np.log(np.float32(E)), device=dev).to(dtype)
    keys = env.observation_keys(model, dev)
    noise = noise.to(device=dev, dtype=torch.float32).to(dtype)
    final_noise = final_noise.to(device=dev, dtype=torch.float32).to(dtype)

    def filled(shape, value, kind=dtype):
        return torch.full(shape, value, dtype=kind, device=dev)

    t = Graph(
        visited=filled((B, N), False, torch.bool), value_lower=filled((B, N), 0.0),
        value_upper=vmax.expand(B, N).clone(), n_count=filled((B, N), 0, i64),
        c_count=filled((B, N, A), 0, i64), sa_count=filled((B, N, A, W), 0, i64),
        sa_cum_reward=filled((B, N, A, W), 0.0), sa_mu_ucb=filled((B, N, A, W), 1.0),
        sa_mu_lcb=filled((B, N, A, W), 0.0), sa_keys=filled((B, N, A, W), 0, i64),
        sa_child=filled((B, N, A, W), -1, i64), sa_n=filled((B, N, A), 0, i64),
        used=filled((B,), 1, i64))
    # each graph's node of every observation, -1 where not met yet
    node_of = filled((B, keys.numel()), -1, i64)
    node_of[rows, env.observation(model, starts)] = 0

    def node_at(state):
        """The node of each row's observation, a new one where it is new."""
        seen = env.observation(model, state)
        node = node_of[rows, seen]
        new = node < 0
        node = torch.where(new, t.used, node)
        node_of[rows, seen] = node
        t.used.add_(new.to(i64))
        return node

    for episode in range(E):
        state = starts
        for h in range(H):
            node = node_at(state)
            at = (rows, node)
            q_up = q_bounds(t.c_count[at], t.sa_child[at], t.sa_count[at], t.sa_mu_ucb[at],
                            t.sa_mu_lcb[at], t.value_upper, t.value_lower, gamma_, vmax,
                            transition_threshold, dtype)[0]
            tied = q_up == q_up.amax(dim=1, keepdim=True)
            action = torch.where(tied, noise[episode, h], -torch.inf).argmax(dim=1)
            state, reward = env.transition(model, state, action, env_noise[episode, h], dtype)

            key = keys[env.observation(model, state)]
            n = t.sa_n[rows, node, action]
            seen = (t.sa_keys[rows, node, action] == key[:, None]) \
                & (torch.arange(W, device=dev) < n[:, None])
            found = seen.any(dim=1)
            new = ~found & (n < W)
            slot = torch.where(found, seen.to(i64).argmax(dim=1), torch.clamp(n, max=W - 1))
            child = node_at(state)

            at = (rows, node, action, slot)
            count = t.sa_count[at] + 1
            total = t.sa_cum_reward[at] + reward
            t.visited[rows, node] = True
            t.n_count[rows, node] += 1
            t.c_count[rows, node, action] += 1
            t.sa_keys[at] = torch.where(new, key, t.sa_keys[at])
            t.sa_child[at] = child
            t.sa_n[rows, node, action] += new.to(i64)
            t.sa_count[at] = count
            t.sa_cum_reward[at] = total
            t.sa_mu_ucb[at] = kl.upper_bound(total, count.to(dtype), reward_threshold)
            t.sa_mu_lcb[at] = lower_bound(total, count.to(dtype), reward_threshold)

        lo, hi = sweeps(t, gamma_, vmax, transition_threshold, accuracy, vi_sweeps, dtype)
        t.value_lower.copy_(lo)
        t.value_upper.copy_(hi)

    root_q = graph_q_bounds(t, t.value_upper, t.value_lower, gamma_, vmax,
                            transition_threshold, dtype)[1][:, 0]
    tied = root_q == root_q.amax(dim=1, keepdim=True)
    return torch.where(tied, final_noise, -torch.inf).argmax(dim=1), t
