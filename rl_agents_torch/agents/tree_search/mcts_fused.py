"""Fused batched MCTS: one shared descend/rollout loop per episode.

Port of ``rl_agents_tpu/agents/tree_search/mcts_fused.py``: the same algorithm
as ``mcts_plan`` (reference: tree_search/mcts.py:100-305: UCT selection, leaf
expansion, random rollout, mean-return backup), restructured so that an
episode is ``H`` sequential steps and one backup pass:

* descend and rollout share ONE fixed H-step loop: each tree is either
  in-tree (UCT action) or rolling out (random action), tracked by a per-tree
  phase bit; every tree takes at most H env steps per episode either way;
* expansion happens inline at the step where a tree first reaches a leaf;
  arena slots are per-episode (episode e expands into ``1 + e*A .. e*A + A``),
  so the tree needs no ``used`` counter and the per-action priors are a
  single static vector;
* the descent path is recorded as node ids (``[B, H+1]``), and the backup is
  ONE gather + scatter-add pass over the whole path instead of a walk over
  parents (path nodes are distinct, so the mean-value updates commute);
* child pointers are a single ``first_child[B, N]`` tensor (children of a
  node are consecutive slots);
* nothing inside an episode reads a value back, so on the card an episode
  whose draws are all injected is captured once as a CUDA graph and
  replayed (``_EpisodeGraph``).

The JAX package lays its arena out node-major ``[N, B]`` and reaches rows
through one-hot masks, for the TPU; here the arena is ``[B, N]`` like every
other arena of this package and rows are indexed directly. Agreement with
``mcts_plan`` is statistical, not bitwise.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, NamedTuple

import torch

from rl_agents_torch.agents.tree_search.mcts import (
    MCTSTree,
    _where_state,
    discount_table,
    gumbel,
    noise_tensor,
)
from rl_agents_torch.envs.base import params_to
from rl_agents_torch.trainer.profiling import counters, span
from rl_agents_torch.utils.device import resolve_device


class _Arena(NamedTuple):
    first_child: Any  # [B, N] i64, -1 when leaf
    count: Any        # [B, N] f32 visit counts
    value: Any        # [B, N] f32 mean returns
    expansions: Any   # [B] i64 (for the compat `used` counter)


def mcts_plan_batch_fused(env, params, states0, generator: torch.Generator | None, prior_probs,
                          rollout_probs, num_actions: int, episodes: int, horizon: int,
                          gamma: float, temperature: float, noise=None, env_noise=None,
                          device="cuda"):
    """Plan for B independent trees; returns (actions [B, H], lengths [B], tree).

    ``noise`` is Gumbel noise ``[episodes, H, 2, A, B]``: at step ``h`` of
    episode ``e``, ``noise[e, h, 0]`` breaks UCT ties and ``noise[e, h, 1]``
    draws the rollout action. Without it, it is drawn from ``generator``.
    ``env_noise`` ``[episodes, H, B, ...]`` is a stochastic env's own draw
    of each step (the step noise its ``step`` takes; the JAX package splits
    one key a tree at every step); without it the env draws from
    ``generator``.

    The returned tree is an ``MCTSTree`` view of the arena (children rebuilt
    from first_child; slots are episode-indexed rather than
    allocation-ordered, which only changes internal node numbering).

    Nothing inside an episode reads a value back, so where
    ``episode_graph_declines`` gives None (every draw injected, a CUDA
    device, no grad, no capture already under way) the episode is captured
    once as a CUDA graph and replayed ``episodes`` times: the same kernels
    in the same order, the same bits. The capture is kept per signature
    (``_EpisodeGraph``) and made in the first call of that signature; a
    plan of fewer episodes shares it, one of more captures again. Every
    other call runs the episodes eagerly.

    Traced (``trainer/profiling.py``), the call is one ``planner.plan`` span
    and one ``mcts.extract`` (the plan and the tree view). An eager episode
    records, each step, ``mcts.select`` (child lookup, inline expansion, the
    UCT and rollout choices), ``env.transition`` and ``mcts.advance``
    (discounted return, state, terminal flag, path record), then one
    ``mcts.backup``; a replayed episode is one ``mcts.episode``.
    ``counters["mcts.steps"]`` counts the steps (episodes x horizon),
    ``"mcts.episode_graph.replays"`` and ``"mcts.episode_eager.calls"`` the
    episodes of each path, ``"mcts.episode_graph.captures"`` the captures,
    and ``"host.syncs"`` the copies from the host; nothing inside the
    episode loop reads a value back. A replay adds what its episode's
    capture counted, so each counter reads as the eager path's.
    """
    device = resolve_device(device)
    with span("planner.plan"):
        given = params
        params = params_to(params, device)
        states0 = params_to(states0, device)
        A, H, E = num_actions, horizon, episodes
        B = states0[0].shape[0]
        N = 1 + E * A
        i64, f32 = torch.int64, torch.float32
        rows = torch.arange(B, device=device)
        offsets = torch.arange(A, device=device)
        discount = discount_table(gamma, H, device)
        # the temperature's copy to the card waits for its stream, and so does
        # each vector or draw handed over from another device
        handed = (prior_probs, rollout_probs, noise, env_noise)
        counters["host.syncs"] += 1 + sum(_copied(x, device) for x in handed)
        prior_probs = prior_probs.to(device=device, dtype=f32)
        # per-action UCT bonus numerator: temperature * |children| * prior(a)
        # (reference mcts.py:275-286; expansion always creates all A children)
        bonus = torch.tensor(temperature, dtype=f32, device=device) * A * prior_probs
        rollout_logits = torch.log(rollout_probs.to(device=device, dtype=f32))
        if noise is not None:
            noise = noise_tensor(noise, device)
        elif generator is None:
            raise ValueError("mcts_plan_batch_fused needs a generator or noise")
        if env_noise is not None:
            env_noise = noise_tensor(env_noise, device)

        graphed = episode_graph_declines(
            env, device, noise, env_noise,
            (*params, *states0, prior_probs, rollout_probs, noise, env_noise)) is None
        if graphed:
            with torch.cuda.device(device):
                replayed = _episode_graph(env, given, params, states0, noise, env_noise, A, H,
                                          N)
                replayed.start(states0, bonus, rollout_logits, discount)
                bases = 1 + torch.arange(E, device=device) * A  # each episode's expansion slots
                for episode in range(E):
                    with span("mcts.episode"):
                        replayed.replay(noise[episode],
                                        None if env_noise is None else env_noise[episode],
                                        bases[episode])
            arena = _Arena(*(x[:, :N] for x in replayed.arena[:3]), replayed.arena.expansions)
        else:
            arena = _Arena(first_child=torch.full((B, N), -1, dtype=i64, device=device),
                           count=torch.zeros((B, N), dtype=f32, device=device),
                           value=torch.zeros((B, N), dtype=f32, device=device),
                           expansions=torch.zeros((B,), dtype=i64, device=device))
            for episode in range(E):
                if noise is not None:
                    g = noise[episode]
                else:  # drawn on the generator's device, then copied to the planner's
                    g = gumbel((H, 2, A, B), generator, device)
                    counters["host.syncs"] += generator.device.type != device.type
                counters["mcts.episode_eager.calls"] += 1
                _episode(env, params, states0, generator, arena, g,
                         None if env_noise is None else env_noise[episode], 1 + episode * A,
                         bonus, rollout_logits, discount, rows, offsets, H)
        first_child, count, value, expansions = arena

        with span("mcts.extract"):
            # -- plan extraction (reference mcts.py:212-218): max count, ties by value
            node = torch.zeros(B, dtype=i64, device=device)
            live = torch.ones(B, dtype=torch.bool, device=device)
            actions = []
            for _ in range(H):
                fc = first_child[rows, node]
                valid = fc >= 0
                kids = torch.where(valid, fc, 0)[:, None] + offsets
                counts = torch.where(valid[:, None], count.gather(1, kids), -1.0)
                vals = torch.where(counts == counts.amax(dim=1, keepdim=True),
                                   value.gather(1, kids), -torch.inf)
                action = vals.argmax(dim=1)
                live = live & valid
                node = torch.where(live, fc + action, node)
                actions.append(torch.where(live, action, -1))
            actions = torch.stack(actions, dim=1)
            lengths = (actions >= 0).sum(dim=1)

            # -- compat MCTSTree view
            expanded = first_child >= 0
            children = torch.where(expanded[:, :, None], first_child[:, :, None] + offsets, -1)
            # the parent of the slots base .. base + A - 1 is whichever node points at
            # base; leaves write a spare column
            parent = torch.full((B, N + 1), -1, dtype=i64, device=device)
            parent.scatter_(1, torch.where(expanded[:, :, None], children, N).reshape(B, N * A),
                            torch.arange(N, device=device).repeat_interleave(A).expand(B, N * A))
            parent = parent[:, :N].contiguous()
            prior = torch.cat([torch.ones(1, dtype=f32, device=device),
                               prior_probs.repeat(E)]).expand(B, N)
            # a replayed plan's arena is the graph's: the caller gets its own copy
            tree = MCTSTree(parent=parent, children=children, count=count.to(i64),
                            value=value.clone() if graphed else value,
                            prior=prior.contiguous(), used=1 + A * expansions)
    return actions, lengths, tree


def _episode(env, params, states0, generator, arena: _Arena, g, env_draws, base, bonus,
             rollout_logits, discount, rows, offsets, H: int):
    """One episode, in place on ``arena``: ``H`` steps of selection, env
    transition and advance from ``states0``, then the backup. ``g`` is the
    episode's noise ``[H, 2, A, B]``, ``env_draws`` its env draws
    ``[H, B, ...]`` or None, ``base`` its first expansion slot: a Python int,
    or a 0-d tensor where the episode is captured."""
    first_child, count, value, expansions = arena
    B = rows.shape[0]
    device = rows.device
    i64, f32 = torch.int64, torch.float32
    state = states0
    node = torch.zeros(B, dtype=i64, device=device)
    in_tree = torch.ones(B, dtype=torch.bool, device=device)
    terminal = torch.zeros(B, dtype=torch.bool, device=device)
    total = torch.zeros(B, dtype=f32, device=device)
    visited = torch.zeros((B, H + 1), dtype=i64, device=device)
    weights = torch.zeros((B, H + 1), dtype=f32, device=device)
    weights[:, 0] = 1.0  # root always on path
    for h in range(H):
        with span("mcts.select"):
            fc = first_child[rows, node]
            has_children = fc >= 0

            # -- inline expansion at first leaf (reference mcts.py:151-154);
            # in_tree implies not terminal
            do_expand = in_tree & ~has_children
            first_child[rows, node] = torch.where(do_expand, base, fc)
            expansions += do_expand

            # -- action: UCT while descending, rollout policy otherwise
            kids = torch.where(has_children, fc, 0)[:, None] + offsets
            scores = value.gather(1, kids) + bonus / (count.gather(1, kids) + 1.0)
            tie_logits = torch.where(scores == scores.amax(dim=1, keepdim=True), 0.0,
                                     -torch.inf)
            act_uct = (tie_logits + g[h, 0].t()).argmax(dim=1)
            act_roll = (rollout_logits + g[h, 1].t()).argmax(dim=1)
            descending = in_tree & has_children
            action = torch.where(descending, act_uct, act_roll)

        # -- env step (masked once terminal)
        with span("env.transition"):
            out = env.transition(params, state, action, generator,
                                 None if env_draws is None else env_draws[h])
        with span("mcts.advance"):
            live = ~terminal
            total = total + torch.where(live, discount[h] * out.reward.to(f32), 0.0)
            state = _where_state(live, out.state, state)
            terminal = terminal | (live & out.terminated)

            # -- tree position + path record
            node = torch.where(descending, fc + action, node)
            visited[:, h + 1] = node
            weights[:, h + 1] = descending
            in_tree = descending & ~terminal
    counters["mcts.steps"] += H

    # -- backup: one pass over the recorded path (reference mcts.py:248-265).
    # Path nodes are distinct within a tree (weights mask the rest), so the
    # per-node running-mean updates commute: each node receives one
    # non-zero term and zeros.
    with span("mcts.backup"):
        count.scatter_add_(1, visited, weights)
        cnt_new = count.gather(1, visited)
        val_old = value.gather(1, visited)
        delta = weights * (total[:, None] - val_old) / torch.clamp(cnt_new, min=1.0)
        value.scatter_add_(1, visited, delta)


def episode_graph_declines(env, device: torch.device, noise, env_noise, inputs):
    """Why a plan runs its episodes eagerly, or None where it replays each as
    one CUDA graph: an episode may be captured when nothing in it draws from
    a generator (``noise`` given, and ``env_noise`` given or an env whose
    ``transition_draws`` is False), no input (``inputs``, None allowed)
    requires grad, the device is CUDA, and its stream is not capturing
    already (a caller's own capture then records the eager episodes). The
    device is tested last, so that on the CPU the other reasons show."""
    if noise is None:
        return "draws from a generator"
    if env_noise is None and getattr(env, "transition_draws", True):
        return "the env draws from a generator"
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        return "grad into an input"
    if device.type != "cuda":
        return "not a CUDA device"
    if torch.cuda.is_current_stream_capturing():
        return "inside a capture"
    return None


class _EpisodeGraph:
    """One MCTS episode of one signature captured as a CUDA graph, and the
    static buffers it reads and writes: the arena (``capacity`` slots a tree),
    the start states, the UCT bonus, the rollout logits, the discount table,
    and one episode's draws and expansion slot. ``start`` loads a plan's
    inputs and clears the arena; ``replay`` copies in an episode's draws and
    slot and replays it, capturing it first in the first plan. Every copy is
    from the device: nothing is read from or written by the host. Nothing
    in a captured episode draws from a generator, so it is given none."""

    def __init__(self, env, given, params, states0, noise, env_noise, num_actions: int,
                 horizon: int, capacity: int):
        device = states0[0].device
        B, A = states0[0].shape[0], num_actions
        f32, i64 = torch.float32, torch.int64
        # the key holds the ids of env and params: held here, they are not reused
        self.held = (env, given, params)
        self.horizon, self.capacity = horizon, capacity
        self.arena = _Arena(first_child=torch.empty((B, capacity), dtype=i64, device=device),
                            count=torch.empty((B, capacity), dtype=f32, device=device),
                            value=torch.empty((B, capacity), dtype=f32, device=device),
                            expansions=torch.empty((B,), dtype=i64, device=device))
        self.states0 = type(states0)(*(torch.empty(x.shape, dtype=x.dtype, device=device)
                                       for x in states0))
        self.g = torch.empty(noise.shape[1:], dtype=noise.dtype, device=device)
        self.env_draws = None if env_noise is None else torch.empty(
            env_noise.shape[1:], dtype=env_noise.dtype, device=device)
        self.base = torch.zeros((), dtype=i64, device=device)
        self.bonus = torch.empty(A, dtype=f32, device=device)
        self.rollout_logits = torch.empty(A, dtype=f32, device=device)
        self.discount = torch.empty(horizon, dtype=f32, device=device)
        self.rows = torch.arange(B, device=device)
        self.offsets = torch.arange(A, device=device)
        self.graph = None
        self.counted = None  # what one episode adds to the counters

    def start(self, states0, bonus, rollout_logits, discount):
        for static, x in zip(self.states0, states0):
            static.copy_(x)
        self.bonus.copy_(bonus)
        self.rollout_logits.copy_(rollout_logits)
        self.discount.copy_(discount)
        self._clear()

    def _clear(self):
        self.arena.first_child.fill_(-1)
        for x in self.arena[1:]:
            x.zero_()

    def _capture(self):
        """Capture the episode on the current device, after one run on a side
        stream (which builds and loads what it launches), from the inputs
        loaded; then clear the arena the run wrote. The run and the capture
        count only as one capture, and ``counted`` keeps what the captured
        episode counted."""
        env, _, params = self.held
        episode = lambda: _episode(env, params, self.states0, None, self.arena, self.g,
                                   self.env_draws, self.base, self.bonus, self.rollout_logits,
                                   self.discount, self.rows, self.offsets, self.horizon)
        before = counters.copy()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            episode()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = counters.copy()
        with torch.cuda.graph(graph):
            episode()
        self.graph, self.counted = graph, counters - warm
        counters.subtract(counters - before)
        counters["mcts.episode_graph.captures"] += 1
        self._clear()

    def replay(self, g, env_draws, base):
        self.g.copy_(g)
        if env_draws is not None:
            self.env_draws.copy_(env_draws)
        self.base.copy_(base)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        counters.update(self.counted)
        counters["mcts.episode_graph.replays"] += 1


# captures kept, the most recently used last; each holds its graph's memory
_GRAPHS_KEPT = 8
_graphs: OrderedDict = OrderedDict()


def _episode_graph(env, given, params, states0, noise, env_noise, num_actions: int,
                   horizon: int, capacity: int) -> _EpisodeGraph:
    """The captured episode of this call's signature: the env and the
    caller's params object (by identity), the state's type, shapes, dtypes
    and device, the action count, the horizon and the draws' shapes. A new
    one, not yet captured, where none is kept or the kept one's arena holds
    fewer than ``capacity`` slots a tree."""
    key = (id(env), id(given), type(states0), tuple((x.shape, x.dtype) for x in states0),
           states0[0].device, num_actions, horizon, noise.shape[1:],
           None if env_noise is None else (env_noise.shape[1:], env_noise.dtype))
    kept = _graphs.pop(key, None)
    if kept is None or kept.capacity < capacity:
        kept = _EpisodeGraph(env, given, params, states0, noise, env_noise, num_actions,
                             horizon, capacity)
    _graphs[key] = kept
    while len(_graphs) > _GRAPHS_KEPT:
        _graphs.popitem(last=False)
    return kept


def _copied(x, device) -> bool:
    """Whether ``x``, a vector or draw handed to the planner, is copied onto
    ``device``: an array, or a tensor on another device. A copy between the
    host and the card waits for the card's stream."""
    return x is not None and (not isinstance(x, torch.Tensor) or x.device.type != device.type)
