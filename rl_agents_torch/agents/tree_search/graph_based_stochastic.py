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
converged freezes under a mask while the others go on; run eagerly, the host
reads whether any tree still sweeps once per sweep and stops when none does.
The constrained expectation (next-state width above 1) is one kernel launch
on a card; on the CPU its Newton solve reads back once per block of trips.

Where every draw is given (the Gumbel tie breaks, and the env's draws or an
env that draws nothing) on a CUDA device, each episode replays one CUDA
graph (``_EpisodeGraph``, as ``mdp_gape.py`` replays an MDP-GapE episode):
its ``horizon`` steps with their paired KL launches, then all ``vi_sweeps``
sweeps of the value iteration, since a capture cannot read back. A tree
whose residual fell to the accuracy is frozen by its mask, so the sweeps
after the last tree froze change no bit. The arenas and the buffers an
episode reads are then static, one set for each signature, loaded and
cleared at a plan's start, and the plan returns copies of them; the root's
final choice runs eagerly on them.

Traced (``trainer/profiling.py``), a plan is one ``planner.plan`` span. An
eager step is a ``gbop.descend`` span (the node's lookup, the optimistic
action, the next state's slot and node, the statistics) holding one
``env.transition`` span, then a ``gbop.bounds`` span (the paired KL launch);
an eager episode ends in a ``gbop.vi`` span (the sweeps). A replayed episode
is one ``gbop.episode`` span (the draws' copies and the replay). At the end
of the plan a ``gbop.root`` span makes the conservative choice.
``counters["gbop.episodes"]`` and ``"gbop.steps"`` count the episodes and
their steps (episodes x H); ``"gbop.episode_graph.captures"`` and
``".replays"`` the episode's captures and replays; ``"host.syncs"`` the
copies of the four host values to the device at a plan's start, of draws
handed over from another device or drawn on a generator's (the tie breaks),
each sweep's read-back where the sweeps run eagerly, and the read of the
arena's fill and the sweeps' count at the plan's end.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import allocation
from rl_agents_torch.agents.tree_search.graph_based import GraphBasedPlannerAgent
from rl_agents_torch.agents.tree_search.mcts_fused import _copied, episode_graph_declines
from rl_agents_torch.agents.tree_search.olop import parse_threshold
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import HashTable, obs_key, table_lookup_or_insert
from rl_agents_torch.ops.kl_bound import kl_bounds_pair_
from rl_agents_torch.trainer.profiling import counters, span
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

    ``counters["gbop_stochastic.vi_calls"]``, ``"gbop_stochastic.vi_sweeps"``
    and ``"gbop_stochastic.vi_tree_sweeps"`` count the value-iteration calls,
    the sweeps they ran (all trees together: until the last one stopped where
    the sweeps run eagerly, all ``vi_sweeps`` in a replayed episode) and the
    sweeps summed over the trees that still needed them.
    """
    device = resolve_device(device)
    with span("planner.plan"):
        return _plan(env, params, states0, obs0, generator, num_actions, episodes, horizon,
                     gamma, accuracy, reward_threshold_coeff, transition_threshold_coeff, width,
                     vi_sweeps, noise, env_noise, device)


def _plan(env, params, states0, obs0, generator, num_actions, episodes, horizon, gamma, accuracy,
          reward_threshold_coeff, transition_threshold_coeff, width, vi_sweeps, noise, env_noise,
          device):
    params = params_to(params, device)
    states0 = params_to(states0, device)
    obs0 = torch.as_tensor(obs0).to(device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    N = _nodes(E, H)
    f32 = torch.float32
    g32 = np.float32(gamma)
    gamma = torch.tensor(g32, device=device)
    vmax = torch.tensor(np.float32(1) / (np.float32(1) - g32), device=device)
    # coefficient * log(episodes) in float32, on the host: one value on every device
    log_time = np.log(np.float32(E))
    reward_threshold = torch.tensor(np.float32(reward_threshold_coeff) * log_time, device=device)
    transition_threshold = torch.tensor(np.float32(transition_threshold_coeff) * log_time,
                                        device=device)
    # the four host values above each wait for the device's queue on their
    # copy, and so does each draw handed over from another device
    counters["host.syncs"] += 4 + sum(_copied(x, device) for x in (*(noise or ()), env_noise))
    action_noise = final_noise = None
    if noise is not None:
        action_noise, final_noise = (noise_tensor(n, device) for n in noise)
    elif generator is None:
        raise ValueError("gbop_stochastic_plan needs a generator or noise")
    if env_noise is not None:
        env_noise = noise_tensor(env_noise, device)

    # a plan whose draws are all given replays each episode from one CUDA
    # graph, on static buffers loaded here; else everything runs eagerly
    replayed = None
    if episode_graph_declines(env, device, action_noise, env_noise,
                              (*params, *states0, obs0)) is None:
        replayed = _episode_graph(env, params, states0, obs0, action_noise, env_noise, A, W, H, E,
                                  accuracy, vi_sweeps)
        replayed.start(params, states0, obs0, (gamma, vmax, reward_threshold,
                                               transition_threshold))
        params, states0, obs0 = replayed.params, replayed.states0, replayed.obs0
        gamma, vmax, reward_threshold, transition_threshold = replayed.scalars
        graph, tree_sweeps = replayed.graph, replayed.tree_sweeps
        rows, slots_w = replayed.rows, replayed.slots
    else:
        graph = _arena(B, N, A, W, states0, device)
        _clear(graph, states0, obs0, vmax)
        tree_sweeps = torch.zeros((), dtype=torch.int64, device=device)
        rows = torch.arange(B, device=device)
        slots_w = torch.arange(W, device=device)
    (_, visited, _, _, n_count, c_count, sa_count, sa_cum_reward, sa_mu_ucb, sa_mu_lcb, sa_keys,
     sa_child, sa_n, states, _) = graph

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

    def value_iteration(lo, hi, read_back: bool):
        """Masked dense Bellman sweeps (the reference's matrix VI form), each
        tree until its residual is at most ``accuracy``. With ``read_back``
        the host stops the sweeps once no tree needs one; without, all
        ``vi_sweeps`` run. ``tree_sweeps`` adds the trees each sweep ran for."""
        active = torch.ones(B, dtype=torch.bool, device=device)
        counters["gbop_stochastic.vi_calls"] += 1
        for _ in range(vi_sweeps):
            tree_sweeps.add_(active.sum())
            q_up, q_lo = all_q_bounds(hi, lo)
            new_hi = torch.where(visited, q_up.amax(dim=2), hi)
            new_lo = torch.where(visited, q_lo.amax(dim=2), lo)
            delta = torch.maximum((new_lo - lo).abs().amax(dim=1), (new_hi - hi).abs().amax(dim=1))
            lo = torch.where(active[:, None], new_lo, lo)
            hi = torch.where(active[:, None], new_hi, hi)
            active = active & (delta > accuracy)
            counters["gbop_stochastic.vi_sweeps"] += 1
            if read_back:
                counters["host.syncs"] += 1
                if not bool(active.any()):
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

    def run_episode(g, env_draws, captured: bool = False):
        """One episode from the root, ``horizon`` steps, then the value
        iteration: Gumbel tie breaks ``g`` ``[H, B, A]`` (None draws them
        from the generator), the env's draws ``env_draws`` ``[H, B, ...]`` or
        None. The table, the node count and the value bounds are written
        back into the arena at its end. A capture records no span and reads
        nothing back (``captured``)."""
        spans = (lambda name: contextlib.nullcontext()) if captured else span
        table, used = graph.table, graph.used
        value_lower, value_upper = graph.value_lower, graph.value_upper
        if g is None:  # drawn on the generator's device, then copied to the planner's
            g = gumbel((H, B, A), generator, device)
            counters["host.syncs"] += generator.device.type != device.type
        state, obs = states0, obs0
        for h in range(H):
            with spans("gbop.descend"):
                table, used, node = register(table, used, obs_key(obs), state)

                # optimistic sampling (graph_based_stochastic.py:42-51)
                q_up = q_from_rows(c_count[rows, node], sa_child[rows, node],
                                   sa_count[rows, node], sa_mu_ucb[rows, node],
                                   sa_mu_lcb[rows, node], value_upper, value_lower)[0]
                ties = q_up == q_up.amax(dim=1, keepdim=True)
                action = (torch.where(ties, 0.0, -torch.inf) + g[h]).argmax(dim=1)
                with spans("env.transition"):
                    out = env.step(params, state, action, generator,
                                   None if env_draws is None else env_draws[h])

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
                # a tensor, not a Python True: a host scalar would be copied
                visited[rows, node] = torch.ones_like(node, dtype=torch.bool)
                n_count[rows, node] += 1
                c_count[rows, node, action] += 1
                sa_keys[at] = torch.where(insert, nkey, sa_keys[at])
                sa_child[at] = next_node
                sa_n[rows, node, action] += insert
                sa_count[at] = cnt
                sa_cum_reward[at] = cum
            # both bounds of the entry, at its offset (node * A + action) * W + slot
            # in the tree's [N, A, W] row
            with spans("gbop.bounds"):
                offset = torch.add(slot, torch.add(action, node, alpha=A), alpha=W)
                kl_bounds_pair_(sa_mu_ucb, sa_mu_lcb, sa_cum_reward, sa_count, offset,
                                reward_threshold)
            state, obs = out.state, out.obs
        with spans("gbop.vi"):
            value_lower, value_upper = value_iteration(value_lower, value_upper,
                                                       read_back=not captured)
        for kept, value in zip((*graph.table, graph.used, graph.value_lower, graph.value_upper),
                               (*table, used, value_lower, value_upper)):
            kept.copy_(value)

    for episode in range(E):
        counters["gbop.episodes"] += 1
        g = None if noise is None else action_noise[episode]
        env_draws = None if env_noise is None else env_noise[episode]
        if replayed is not None:
            with span("gbop.episode"):
                replayed.replay(g, env_draws, run_episode)
        else:
            run_episode(g, env_draws)
        counters["gbop.steps"] += H

    # the arena's fill and the sweeps' count in one read
    counters["host.syncs"] += 1
    used_max, swept = torch.stack([graph.used.max(), tree_sweeps]).tolist()
    counters["gbop_stochastic.vi_tree_sweeps"] += swept
    if used_max > N:
        raise AssertionError(f"a graph allocated {used_max} nodes in an arena of {N}")
    with span("gbop.root"):
        # conservative plan at the root (graph_based.py:126-135 semantics)
        root_q = all_q_bounds(graph.value_upper, graph.value_lower)[1][:, 0]
        ties = root_q == root_q.amax(dim=1, keepdim=True)
        if noise is None:
            final_noise = gumbel((B, A), generator, device)
            counters["host.syncs"] += generator.device.type != device.type
        action = (torch.where(ties, 0.0, -torch.inf) + final_noise).argmax(dim=1)
    if replayed is None:
        return action, graph
    # copies of the static arenas: the next plan overwrites them
    copied = lambda x: type(x)(*(y.clone() for y in x)) if isinstance(x, tuple) else x.clone()
    return action, StochasticGraph(*map(copied, graph))


def _nodes(episodes: int, horizon: int) -> int:
    """Decision nodes a graph holds: the root, one a step, and one spare."""
    return 2 + episodes * horizon


def _arena(B: int, N: int, A: int, W: int, states0, device) -> StochasticGraph:
    """Uninitialised arenas of B graphs of ``N`` nodes, their hash tables of
    ``2 N`` slots and their states like ``states0``'s (``_clear`` fills them)."""
    i64, f32 = torch.int64, torch.float32
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device)
    return StochasticGraph(
        table=HashTable(keys=empty((B, 2 * N), i64), values=empty((B, 2 * N), i64),
                        count=empty((B,), i64)),
        visited=empty((B, N), torch.bool), value_lower=empty((B, N), f32),
        value_upper=empty((B, N), f32), n_count=empty((B, N), i64), c_count=empty((B, N, A), i64),
        sa_count=empty((B, N, A, W), i64), sa_cum_reward=empty((B, N, A, W), f32),
        sa_mu_ucb=empty((B, N, A, W), f32), sa_mu_lcb=empty((B, N, A, W), f32),
        sa_keys=empty((B, N, A, W), i64), sa_child=empty((B, N, A, W), i64),
        sa_n=empty((B, N, A), i64),
        states=type(states0)(*(empty((B, N) + x.shape[1:], x.dtype) for x in states0)),
        used=empty((B,), i64))


# the arenas' values at a plan's start; the upper value bounds hold ``vmax``,
# ``_clear``'s argument
_FILLS = dict(visited=False, value_lower=0.0, value_upper=None, n_count=0, c_count=0, sa_count=0,
              sa_cum_reward=0.0, sa_mu_ucb=1.0, sa_mu_lcb=0.0, sa_keys=0, sa_child=-1, sa_n=0,
              used=1)


def _clear(graph: StochasticGraph, states0, obs0, vmax) -> None:
    """Fill the arenas with a plan's start: each tree's root, node 0, at its
    start state ``states0`` and in its table under ``obs0``'s key, the fields'
    constants, and ``vmax`` (a 0-d tensor) in the upper value bounds."""
    B = states0[0].shape[0]
    keys, values, count = graph.table
    keys.zero_()
    values.fill_(-1)
    count.zero_()
    root = torch.zeros(B, dtype=torch.int64, device=keys.device)
    for kept, value in zip(graph.table, table_lookup_or_insert(graph.table, obs_key(obs0),
                                                               root)[0]):
        kept.copy_(value)
    for name, fill in _FILLS.items():
        getattr(graph, name).fill_(vmax if fill is None else fill)
    for arena, value in zip(graph.states, states0):
        arena.zero_()
        arena[:, 0] = value


class _EpisodeGraph:
    """A stochastic GBOP episode (``run_episode`` in ``_plan``: ``horizon``
    steps with their paired KL launches, then every sweep of the value
    iteration) of one signature captured as a CUDA graph, and the static
    buffers it reads and writes: the params, the start states and their
    observations, the four scalars (gamma, the largest value, the reward and
    the transition thresholds), the arenas, the index vectors, the sweeps'
    count and one episode's draws. ``start`` loads a plan's inputs and clears
    the arenas; ``replay`` copies in an episode's draws and replays the
    episode, capturing it first in the first plan. Every copy is from the
    device. The root's final choice runs eagerly on the same buffers."""

    def __init__(self, env, params, states0, obs0, noise, env_noise, num_actions: int,
                 width: int, horizon: int, episodes: int):
        device = states0[0].device
        B = states0[0].shape[0]
        self.env = env  # the key holds id(env): held here, it is not reused
        like = lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
        self.params = type(params)(*map(like, params))
        self.states0 = type(states0)(*map(like, states0))
        self.obs0 = like(obs0)
        self.scalars = tuple(torch.empty((), dtype=torch.float32, device=device) for _ in range(4))
        self.graph = _arena(B, _nodes(episodes, horizon), num_actions, width, states0, device)
        self.tree_sweeps = torch.empty((), dtype=torch.int64, device=device)
        self.rows = torch.arange(B, device=device)
        self.slots = torch.arange(width, device=device)
        self.g = like(noise[0])
        self.env_draws = None if env_noise is None else like(env_noise[0])
        self.cuda_graph = self.counted = None

    def start(self, params, states0, obs0, scalars):
        for static, x in zip((*self.params, *self.states0, self.obs0, *self.scalars),
                             (*params, *states0, obs0, *scalars)):
            static.copy_(x)
        self._clear()

    def _clear(self):
        _clear(self.graph, self.states0, self.obs0, self.scalars[1])
        self.tree_sweeps.zero_()

    def replay(self, g, env_draws, run_episode):
        self.g.copy_(g)
        if env_draws is not None:
            self.env_draws.copy_(env_draws)
        if self.cuda_graph is None:
            self._capture(run_episode)
        self.cuda_graph.replay()
        counters.update(self.counted)
        counters["gbop.episode_graph.replays"] += 1

    def _capture(self, run_episode):
        """Capture the episode on the current device, after one run on a side
        stream (which builds and loads what it launches), from the inputs
        loaded at a plan's first episode; then clear the arenas the run
        wrote. The run and the capture count only as one capture, and
        ``counted`` keeps what the captured episode counted."""
        run = lambda: run_episode(self.g, self.env_draws, captured=True)
        before = counters.copy()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        cuda_graph = torch.cuda.CUDAGraph()
        warm = counters.copy()
        with torch.cuda.graph(cuda_graph):
            run()
        self.cuda_graph, self.counted = cuda_graph, counters - warm
        counters.subtract(counters - before)
        counters["gbop.episode_graph.captures"] += 1
        self._clear()


# captures kept, the most recently used last; each holds its arenas and its graph's memory
_GRAPHS_KEPT = 4
_graphs: OrderedDict = OrderedDict()


def _episode_graph(env, params, states0, obs0, noise, env_noise, num_actions: int, width: int,
                   horizon: int, episodes: int, accuracy: float,
                   vi_sweeps: int) -> _EpisodeGraph:
    """The captured episode of this call's signature: the env (by identity),
    the params', the state's and the observation's types, shapes and dtypes,
    the device, the action count, the slot count, the horizon, the episodes
    (the arena's size), the draws' shapes, the accuracy and the sweeps (the
    value iteration's constants). A new one, not yet captured, where none is
    kept."""
    key = (id(env), type(params), tuple((x.shape, x.dtype) for x in params), type(states0),
           tuple((x.shape, x.dtype) for x in states0), (obs0.shape, obs0.dtype),
           states0[0].device, num_actions, width, horizon, episodes, noise.shape[1:],
           None if env_noise is None else (env_noise.shape[1:], env_noise.dtype),
           float(accuracy), int(vi_sweeps))
    kept = _graphs.pop(key, None)
    if kept is None:
        kept = _EpisodeGraph(env, params, states0, obs0, noise, env_noise, num_actions, width,
                             horizon, episodes)
    _graphs[key] = kept
    while len(_graphs) > _GRAPHS_KEPT:
        _graphs.popitem(last=False)
    return kept


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
