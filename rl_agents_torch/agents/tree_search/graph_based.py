"""Graph-based optimistic planning (deterministic, GBOP-D), batch-first.

Port of ``rl_agents_tpu/agents/tree_search/graph_based.py`` (reference:
tree_search/graph_based.py:12-151): nodes are aggregated by observation (an
obs-key array per tree replaces the ``planner.nodes`` dict,
graph_based.py:110-116); each expansion simulates every action and records
rewards and edges (graph_based.py:39-53); value intervals [lower, upper] start
at [0, 1/(1-gamma)] and are tightened by masked global Bellman sweeps over all
expanded nodes until the residual drops to ``accuracy``.

Every arena field carries a leading tree axis B, and child values are read
with ``gather``; the JAX package's dense ``[N, A, N]`` child matrices and
growing arenas exist only for the TPU. One arena of the final size serves
every round: rows beyond ``used`` are inert (no children, not expanded). Under
``jax.vmap`` each tree leaves the sweep loop at its own trip, and further
sweeps would tighten its bounds, so a tree whose residual fell to ``accuracy``
freezes under a mask while the others go on; the host reads the number of
trees still sweeping once per trip (two sweeps).

The env is stepped with its ``null_noise``: the planner is deterministic and
plans against one frozen outcome of the env's draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import gumbel, noise_tensor


class Graph(NamedTuple):
    keys: Any          # [B, N] i64 holding 32-bit obs keys (valid below `used`)
    expanded: Any      # [B, N] bool
    value_lower: Any   # [B, N] f32
    value_upper: Any   # [B, N] f32
    rewards: Any       # [B, N, A] f32
    children: Any      # [B, N, A] i64, -1 when absent
    states: Any        # state NamedTuple stacked as [B, N, ...]
    used: Any          # [B] i64


def _q_table(children, rewards, vals, gamma, default):
    """Q[b, n, a] = r[b, n, a] + gamma * vals[b, children[b, n, a]], with
    ``default`` where the child is absent. ``vals`` may carry leading axes
    before ``[B, N]`` (both bounds at once); ``default`` broadcasts against
    the result. The multiply-add is fused, as XLA compiles it."""
    B, N, A = children.shape
    index = children.clamp(min=0).reshape(B, N * A).expand(vals.shape[:-1] + (N * A,))
    child_vals = vals.gather(-1, index).reshape(vals.shape + (A,))
    return fma(gamma, torch.where(children >= 0, child_vals, default), rewards)


def _value_iteration_sweeps(graph: Graph, gamma, accuracy, max_sweeps: int = 100) -> Graph:
    """Masked global Bellman sweeps of both bounds, two per trip, until the
    residual between the second and the first is at most ``accuracy``
    (per tree) or ``max_sweeps`` sweeps were made.

    ``_value_iteration_sweeps.calls`` counts the calls, ``.sweeps`` the sweeps
    they ran (all trees together, until the last one stopped) and
    ``.tree_sweeps`` the sweeps summed over the trees that still needed them."""
    device = graph.children.device
    vmax = 1.0 / (1.0 - gamma)
    defaults = torch.stack([torch.zeros((), device=device), vmax]).reshape(2, 1, 1, 1)
    expanded = graph.expanded[None]

    def sweep(vals):
        q = _q_table(graph.children, graph.rewards, vals, gamma, defaults)
        return torch.where(expanded, q.amax(dim=-1), vals)

    vals = torch.stack([graph.value_lower, graph.value_upper])  # [2, B, N]
    active = torch.ones(vals.shape[1], dtype=torch.bool, device=device)
    n_active = vals.shape[1]
    _value_iteration_sweeps.calls += 1
    for _ in range(0, max_sweeps, 2):
        mid = sweep(vals)
        new = sweep(mid)
        delta = (new - mid).abs().amax(dim=(0, 2))
        vals = torch.where(active[None, :, None], new, vals)
        active = active & (delta > accuracy)
        _value_iteration_sweeps.sweeps += 2
        _value_iteration_sweeps.tree_sweeps += 2 * n_active
        n_active = int(active.sum())
        if n_active == 0:
            break
    return graph._replace(value_lower=vals[0], value_upper=vals[1])


_value_iteration_sweeps.calls = _value_iteration_sweeps.sweeps = 0
_value_iteration_sweeps.tree_sweeps = 0


def _scatter_fresh(arena, used, fresh, new):
    """Write ``new[b, a]`` for the fresh actions ``a`` of each tree, in action
    order, into the consecutive rows of ``arena [B, N, ...]`` from ``used[b]``
    on, in place.

    Row ``used + j`` takes the j-th fresh action. The indices past the last
    fresh action repeat its write (same row, same value), and a tree with no
    fresh action writes row 0's own value back, so that every duplicate index
    carries one value and the ``index_put_`` is deterministic."""
    B, A = fresh.shape
    rows = torch.arange(B, device=fresh.device)[:, None]
    n_fresh = fresh.sum(dim=1)
    # fresh actions first, in action order
    order = torch.argsort((~fresh).to(torch.int8), dim=1, stable=True)
    j = torch.minimum(torch.arange(A, device=fresh.device)[None, :],
                      (n_fresh - 1).clamp(min=0)[:, None])
    any_fresh = (n_fresh > 0)[:, None]
    target = torch.where(any_fresh, used[:, None] + j, 0)
    value = new[rows, order.gather(1, j)]
    mask = any_fresh.reshape((B, 1) + (1,) * (value.dim() - 2))
    arena[rows, target] = torch.where(mask, value, arena[rows, target])


def _get_or_insert(keys, used, okeys):
    """Get-or-insert of A obs keys per tree into the node key arrays
    ``keys [B, N]``, of which ``used [B]`` are valid.

    Reproduces the sequential action-order insert exactly: an existing key
    resolves to its node; duplicate new keys within the round share the first
    occurrence's slot; distinct new keys take consecutive slots from ``used``
    in action order (graph_based.py:110-116 semantics).

    Returns ``(keys, used, node_ids [B, A], fresh [B, A], slots [B, A])``;
    the argument ``keys`` is not written."""
    B, N = keys.shape
    A = okeys.shape[1]
    device = keys.device
    in_use = torch.arange(N, device=device) < used[:, None]
    match = (keys[:, None, :] == okeys[:, :, None]) & in_use[:, None, :]      # [B, A, N]
    exists = match.any(dim=2)
    existing = match.to(torch.int8).argmax(dim=2)
    iota = torch.arange(A, device=device)
    first_of = (okeys[:, None, :] == okeys[:, :, None]).to(torch.int8).argmax(dim=2)  # [B, A]
    dup = first_of < iota
    fresh = ~exists & ~dup
    offs = fresh.cumsum(dim=1) - fresh.to(torch.int64)
    slots = used[:, None] + offs
    node_ids = torch.where(exists, existing, slots)
    # duplicates alias the first occurrence's id
    node_ids = torch.where(dup & ~exists, node_ids.gather(1, first_of), node_ids)
    new_keys = keys.clone()
    _scatter_fresh(new_keys, used, fresh, okeys)
    return new_keys, used + fresh.sum(dim=1), node_ids, fresh, slots


def gbop_plan(env: FunctionalEnv, params, states0, obs0, generator: torch.Generator | None,
              num_actions: int, expansions: int, gamma: float, accuracy: float = 1e-2,
              sampling_timeout: int = 100, capacity: int = 0, noise=None, device="cuda"):
    """Plan B graphs at once from ``states0`` (a state NamedTuple with a
    leading batch dim) and their observations ``obs0 [B, ...]``. Returns
    ``(actions [B, P] with -1 past the plan, lengths [B], Graph)``.

    ``noise`` is a sequence of ``expansions`` Gumbel tensors, ``noise[r]`` of
    shape ``[B, n_r, A]``: its row ``n`` breaks the ties of node ``n``'s
    optimistic action in round ``r``. ``n_r`` is any size that covers the
    nodes allocated before round ``r`` (the JAX package draws ``n_r`` rows for
    an arena that grows with the round). Without it, ``[B, N, A]`` is drawn
    from ``generator`` each round.
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    obs0 = torch.as_tensor(obs0).to(device)
    A = num_actions
    B = states0[0].shape[0]
    # the arena is rounded up to a multiple of 8 rows, as in the JAX package
    # (the extra rows are inert: never key-matched)
    N = capacity or -((1 + expansions * A) // -8) * 8
    if N < 1 + expansions * A:
        raise ValueError(f"capacity {N} cannot hold 1 + {expansions} x {A} nodes")
    if noise is None and generator is None:
        raise ValueError("gbop_plan needs a generator or noise")
    i64, f32 = torch.int64, torch.float32
    g32 = np.float32(gamma)
    gamma = torch.tensor(g32, device=device)
    vmax = torch.tensor(np.float32(1) / (np.float32(1) - g32), device=device)
    rows = torch.arange(B, device=device)
    iota_n = torch.arange(N, device=device)

    def arena_of(x):
        arena = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=device)
        arena[:, 0] = x
        return arena

    keys = torch.zeros((B, N), dtype=i64, device=device)
    keys[:, 0] = obs_key(obs0)
    graph = Graph(
        keys=keys,
        expanded=torch.zeros((B, N), dtype=torch.bool, device=device),
        value_lower=torch.zeros((B, N), dtype=f32, device=device),
        value_upper=vmax.expand(B, N).clone(),
        rewards=torch.zeros((B, N, A), dtype=f32, device=device),
        children=torch.full((B, N, A), -1, dtype=i64, device=device),
        states=type(states0)(*(arena_of(x) for x in states0)),
        used=torch.ones((B,), dtype=i64, device=device))
    # an acyclic optimistic descent visits at most the expanded-node count
    # (<= expansions) before absorbing at an unexpanded node; cyclic descents
    # stop wherever the cap lands, and re-expanding an expanded node is a
    # no-op: the same outcome as the reference's sampling-timeout bailout
    # (graph_based.py:96-108)
    walk_len = min(expansions, sampling_timeout)
    actions_rep = torch.arange(A, device=device).repeat(B)
    null_noise = env.null_noise(B * A, device)

    def descend(graph: Graph, g):
        """Optimistic sampling until an unexpanded node (graph_based.py:96-108).
        Bounds are frozen during a descent, so each node's greedy action,
        the argmax of Q-upper with one Gumbel draw per node and round for the
        ties, defines a successor map that the walk follows from the root for
        ``walk_len`` hops, unexpanded nodes absorbing."""
        n = g.shape[1]
        q_up = _q_table(graph.children, graph.rewards, graph.value_upper, gamma, vmax)[:, :n]
        ties = q_up == q_up.amax(dim=2, keepdim=True)
        a_star = (torch.where(ties, 0.0, -torch.inf) + g).argmax(dim=2)           # [B, n]
        succ = graph.children[:, :n].gather(2, a_star[:, :, None]).squeeze(2)
        f = iota_n.expand(B, N).clone()
        f[:, :n] = torch.where(graph.expanded[:, :n], succ, f[:, :n])
        node = torch.zeros(B, dtype=i64, device=device)
        for _ in range(walk_len):
            node = f.gather(1, node[:, None]).squeeze(1)
        return node

    def expand(graph: Graph, node) -> Graph:
        """Simulate all actions of ``node [B]``; aggregate the next states
        through the key array (graph_based.py:39-53). In place on the arenas
        of ``graph`` except its keys."""
        state = type(states0)(*(x[rows, node].repeat_interleave(A, dim=0) for x in graph.states))
        out = env.step(params, state, actions_rep, None, null_noise)
        okeys = obs_key(out.obs).reshape(B, A)
        keys, used, children_row, fresh, _ = _get_or_insert(graph.keys, graph.used, okeys)
        for arena, new in zip(graph.states, out.state):
            _scatter_fresh(arena, graph.used, fresh, new.reshape((B, A) + new.shape[1:]))
        graph.rewards[rows, node] = out.reward.to(f32).reshape(B, A)
        graph.children[rows, node] = children_row
        graph.expanded[rows, node] = True
        return graph._replace(keys=keys, used=used)

    for r in range(expansions):
        g = noise_tensor(noise[r], device) if noise is not None else gumbel(
            (B, N, A), generator, device)
        node = descend(graph, g)
        graph = expand(graph, node)
        graph = _value_iteration_sweeps(graph, gamma, accuracy)

    # conservative plan: descend by lower-bound argmax (graph_based.py:126-135)
    q_lo = _q_table(graph.children, graph.rewards, graph.value_lower, gamma,
                    torch.zeros((), device=device))
    node = torch.zeros(B, dtype=i64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(min(sampling_timeout, 64)):
        action = q_lo[rows, node].argmax(dim=1)  # first max, like the reference's max()
        live = live & graph.expanded[rows, node]
        node = torch.where(live, graph.children[rows, node, action], node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    return actions, (actions >= 0).sum(dim=1), graph


class GraphBasedPlannerAgent(AbstractTreeSearchAgent):
    """(reference: graph_based.py:141-151)"""

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({"budget": 100, "sampling_timeout": 100, "accuracy": 1e-2})
        return cfg

    def make_planner(self):
        pass

    def planner_plan(self, env, observation):
        functional = env.functional
        A = functional.action_space.n
        expansions = max(int(self.config["budget"]) // A, 1)
        actions, length, graph = gbop_plan(
            functional, env.params, env.state, functional.observe(env.params, env.state),
            self.generator, num_actions=A, expansions=expansions,
            gamma=float(self.config["gamma"]), accuracy=float(self.config["accuracy"]),
            sampling_timeout=int(self.config["sampling_timeout"]), device=self.device)
        self.last_plan_data = graph
        return self.get_plan_list(actions[0], length[0])
