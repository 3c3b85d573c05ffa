"""Open-Loop Optimistic Planning (OLOP / KL-OLOP), batch-first over trees.

Port of ``rl_agents_tpu/agents/tree_search/olop.py`` (reference:
tree_search/olop.py:11-200). The budget is split into M episodes of horizon
L; each episode descends the action-sequence tree of every one of B trees by
maximal B-value, expanding leaves on the way, updates the visited nodes'
reward upper confidence bounds, then backs the sequence B-values
``value_upper = mu_ucb + gamma * max(children)`` up to the root.

Where the JAX package vmaps a single-tree program, this one carries a
leading tree axis on every arena field and indexes rows directly with
``(arange(B), node)``; the one-hot masked access of the JAX package exists
only for the TPU. The KL-UCB of every node an episode visited is one
``kl_bound_indexed_`` call over that episode's path ``[H, B]``, after its
descent: on a CUDA device that is one launch of the hand-written kernel per
episode. Nothing inside the episode loop reads a value back to the host, so
on the card an episode that draws nothing is one CUDA-graph replay
(``_EpisodeGraph``).
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent, allocation
from rl_agents_torch.agents.tree_search.episode_graph import EpisodeGraph, Kept, env_key
from rl_agents_torch.agents.tree_search.mcts_fused import episode_graph_declines
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.kl_bound import kl_bound_indexed_
from rl_agents_torch.trainer.profiling import counters, span
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS, fma
from rl_agents_torch.utils.noise import noise_tensor


def parse_threshold(spec, default_coeff: float = 4.0) -> float:
    """Parse a threshold spec: a number, or the reference's legacy
    "<c>*np.log(time)" string form (no eval)."""
    if isinstance(spec, (int, float)):
        return float(spec)
    if isinstance(spec, str):
        m = re.fullmatch(r"\s*([\d.]+)\s*\*\s*np\.log\(\s*time\s*\)\s*", spec)
        if m:
            return float(m.group(1))
        raise ValueError(f"Unsupported threshold spec {spec!r}; use a coefficient c for c*log(time)")
    return default_coeff


class OLOPTree(NamedTuple):
    parent: Any       # [B, N] i64
    children: Any     # [B, N, A] i64
    depth: Any        # [B, N] i64
    count: Any        # [B, N] i64
    cum_reward: Any   # [B, N] f32
    mu_ucb: Any       # [B, N] f32
    value_upper: Any  # [B, N] f32  (sequence B-value)
    done: Any         # [B, N] bool
    used: Any         # [B] i64


def olop_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None = None, *,
              num_actions: int, episodes: int, horizon: int, gamma: float,
              threshold_coeff: float, ucb_type: str = "kullback-leibler",
              time_global: bool = True, continuation_uniform: bool = False,
              random_actions=None, env_noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim). Returns ``(actions [B, H] with -1 past the plan, lengths [B],
    OLOPTree)``.

    ``continuation_uniform`` continues leaves with uniform random actions:
    ``random_actions`` ``[episodes, horizon, B]`` supplies them, else they are
    drawn from ``generator``. ``env_noise`` is a stochastic env's own noise
    for every step, ``[episodes, horizon, B, ...]``; without it the env draws
    from ``generator``.

    The continuation actions are drawn before the first episode, so where
    ``episode_graph_declines`` gives None (``env_noise`` given or an env
    whose transition draws nothing, such as the highway family; no grad; a
    CUDA device; no capture already under way) nothing inside an episode
    draws, and each episode replays one CUDA graph (``_EpisodeGraph``,
    captured in the first plan of its signature; a plan of fewer episodes
    shares it, one of more captures again). Every other call runs the
    episodes eagerly. Both run ``_episode``: the same kernels in the same
    order, the same bits.

    Traced (``trainer/profiling.py``), the call is one ``planner.plan`` span;
    an eager episode records ``env.transition`` at each step, a replayed one
    is one ``olop.episode``. ``counters["olop.episode_graph.replays"]`` and
    ``"olop.episode_eager.calls"`` count the episodes of each path,
    ``"olop.episode_graph.captures"`` the captures, and ``"host.syncs"`` the
    plan's copies from the host; nothing inside the episode loop reads a
    value back. A replay adds what its capture counted, so each counter
    reads as the eager path's.
    """
    device = resolve_device(device)
    with span("planner.plan"):
        params = params_to(params, device)
        states0 = params_to(states0, device)
        A, H, E = num_actions, horizon, episodes
        B = states0[0].shape[0]
        N = 1 + E * H * A
        i64, f32 = torch.int64, torch.float32
        # initial B-values (1 - gamma^(H+1-depth)) / (1 - gamma), tabulated on the
        # host with scalar float32 powf: vectorized pows (torch's, numpy's) round
        # some powers differently, and these values meet backed-up ones in exact
        # ties, so each rounding step decides which branch a descent takes
        g32 = np.float32(gamma)
        upper_table = torch.tensor(
            [(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32) for k in range(H + 2)],
            dtype=f32, device=device)
        gamma = torch.tensor(g32, device=device)
        counters["host.syncs"] += 2  # the two copies to the card wait for its stream
        kl = ucb_type == "kullback-leibler"
        rows = torch.arange(B, device=device)

        time = torch.arange(1, E + 1, dtype=f32, device=device) if not time_global \
            else torch.full((E,), float(E), dtype=f32, device=device)
        thresholds = threshold_coeff * torch.log(time)

        if continuation_uniform:
            if random_actions is None:
                if generator is None:
                    raise ValueError("continuation_uniform needs a generator or random_actions")
                random_actions = torch.randint(0, A, (E, H, B), generator=generator,
                                               device=generator.device).to(device)
            if not isinstance(random_actions, torch.Tensor):
                random_actions = torch.tensor(np.asarray(random_actions))
            random_actions = random_actions.to(device=device, dtype=i64)
        else:
            random_actions = torch.zeros((E, H, B), dtype=i64, device=device)

        if env_noise is not None:
            env_noise = noise_tensor(env_noise, device)

        if episode_graph_declines(env, device, random_actions, env_noise,
                                  (*params, *states0, env_noise)) is None:
            replayed = _episode_graph(env, params, states0, env_noise, A, H, kl, N)
            replayed.start(params, states0, upper_table, gamma)
            for episode in range(E):
                with span("olop.episode"):
                    replayed.replay(random_actions[episode], thresholds[episode],
                                    None if env_noise is None else env_noise[episode])
            # later plans replay into the same buffers: the caller gets copies,
            # cut to this plan's N slots
            tree = OLOPTree(*(x[:, :N].clone() for x in replayed.tree[:-1]),
                            replayed.tree.used.clone())
        else:
            tree = _start(_arena(B, N, A, device), upper_table, kl)
            offsets = torch.arange(A, device=device)
            path = torch.empty((H, B), dtype=i64, device=device)
            for episode in range(E):
                counters["olop.episode_eager.calls"] += 1
                _episode(env, params, states0, generator, tree, random_actions[episode],
                         thresholds[episode], None if env_noise is None else env_noise[episode],
                         upper_table, gamma, rows, offsets, path, kl)

        # plan extraction: best count, ties by value_upper (olop.py:126-130)
        node = torch.zeros(B, dtype=i64, device=device)
        live = torch.ones(B, dtype=torch.bool, device=device)
        actions = []
        for _ in range(H):
            ch = tree.children[rows, node]
            valid = ch >= 0
            counts = _child_values(tree.count, ch, -1)
            cvu = _child_values(tree.value_upper, ch, 0.0)
            tie = valid & (counts == counts.amax(dim=1, keepdim=True))
            action = torch.where(tie, cvu, -torch.inf).argmax(dim=1)
            child = ch.gather(1, action[:, None]).squeeze(1)
            live = live & valid.any(dim=1)
            node = torch.where(live, child, node)
            actions.append(torch.where(live, action, -1))
        actions = torch.stack(actions, dim=1)
        lengths = (actions >= 0).sum(dim=1)
        return actions, lengths, tree


def _child_values(values, ch, fill):
    """values[b, ch[b, a]] where ch >= 0, else ``fill``."""
    return torch.where(ch >= 0, values.gather(1, ch.clamp(min=0)), fill)


def _arena(trees: int, slots: int, num_actions: int, device) -> OLOPTree:
    """An unfilled ``OLOPTree`` of ``slots`` slots for each of ``trees`` trees."""
    i64, f32 = torch.int64, torch.float32
    empty = lambda dtype, *shape: torch.empty((trees, slots, *shape), dtype=dtype, device=device)
    return OLOPTree(parent=empty(i64), children=empty(i64, num_actions), depth=empty(i64),
                    count=empty(i64), cum_reward=empty(f32), mu_ucb=empty(f32),
                    value_upper=empty(f32), done=empty(torch.bool),
                    used=torch.empty(trees, dtype=i64, device=device))


def _start(tree: OLOPTree, upper_table, kl: bool) -> OLOPTree:
    """``tree`` filled in place as a plan starts: every tree its root alone,
    no parent or children, zero statistics, the reward bounds 1 (KL) or inf
    (Hoeffding), the root's B-value the table's last entry (depth 0), one
    slot used. Every write stays on the device."""
    parent, children, depth, count, cum_reward, mu_ucb, value_upper, done, used = tree
    parent.fill_(-1)
    children.fill_(-1)
    for x in (depth, count, cum_reward, value_upper, done):
        x.zero_()
    mu_ucb.fill_(1.0 if kl else torch.inf)
    value_upper[:, 0] = upper_table[-1]
    used.fill_(1)
    return tree


def _episode(env, params, states0, generator, tree: OLOPTree, continuation, threshold,
             env_draws, upper_table, gamma, rows, offsets, path, kl: bool):
    """One episode, in place on ``tree`` (``[B, N]`` arenas at any N the
    plan's nodes fit in): the H-step descent from ``states0`` by maximal
    B-value, expanding leaves and continuing them with ``continuation``
    ``[H, B]``, then the reward upper bounds of the path's nodes under the 0-d
    ``threshold``, then the B-values backed up to the roots. ``env_draws`` is
    the episode's env noise ``[H, B, ...]`` or None, ``path`` an ``[H, B]``
    buffer the descent writes."""
    parent, children, depth, count, cum_reward, mu_ucb, value_upper, done, used = tree
    H, B = path.shape
    A = offsets.shape[0]
    N = parent.shape[1]
    f32 = torch.float32
    node = torch.zeros(B, dtype=torch.int64, device=rows.device)
    state = states0
    for h in range(H):
        # expand when leaf (reference: olop.py:79-82)
        is_leaf = children[rows, node, 0] < 0
        leaf_a = is_leaf[:, None]
        child_ids = used[:, None] + offsets
        children[rows, node] = torch.where(leaf_a, child_ids, children[rows, node])
        # a full arena puts non-leaf trees' ids past the end: clamp, and
        # write the old values back there
        slots = child_ids.clamp(max=N - 1)
        d = (depth[rows, node] + 1)[:, None].expand(B, A)
        parent.scatter_(1, slots, torch.where(leaf_a, node[:, None].expand(B, A),
                                              parent.gather(1, slots)))
        depth.scatter_(1, slots, torch.where(leaf_a, d, depth.gather(1, slots)))
        value_upper.scatter_(1, slots, torch.where(leaf_a, upper_table[H + 1 - d],
                                                   value_upper.gather(1, slots)))
        used += torch.where(is_leaf, A, 0)

        ch = children[rows, node]
        ucb_action = _child_values(value_upper, ch, -torch.inf).argmax(dim=1)
        action = torch.where(is_leaf, continuation[h], ucb_action)

        with span("env.transition"):  # the observation is unused
            out = env.transition(params, state, action, generator,
                                 None if env_draws is None else env_draws[h])
        child = ch.gather(1, action[:, None]).squeeze(1)
        # node reward statistics update (reference: olop.py:132-142)
        child_done = out.terminated | done[rows, child]
        reward = torch.where(child_done, 0.0, out.reward.to(f32))
        cum_reward[rows, child] = cum_reward[rows, child] + reward
        count[rows, child] = count[rows, child] + 1
        done[rows, child] = child_done
        path[h] = child
        node, state = child, out.state

    # the reference updates mu_ucb at every step of the descent
    # (olop.py:132-142); one update over the whole path after it is exact:
    # mu_ucb is read only by the backup below, and depth grows by one a
    # step, so the path visits each node once and its statistics are final
    if kl:
        kl_bound_indexed_(mu_ucb, cum_reward, count, path, threshold,
                          iters=NEWTON_MAX_ITERATIONS, eps=1e-2)
    else:
        # hoeffding: mu + sqrt(threshold / (2 n)) (the reference's hoeffding
        # branch is dormant, olop.py:153-158)
        path_rows = rows.expand(H, B)
        cnt = count[path_rows, path].to(f32)
        safe = torch.clamp(cnt, min=1.0)
        bound = cum_reward[path_rows, path] / safe + torch.sqrt(threshold / (2.0 * safe))
        mu_ucb[path_rows, path] = torch.where(cnt == 0, torch.inf, bound)

    # backup B-values to the root (reference: olop.py:182-193); a leaf
    # lies at depth <= H, so H + 1 trips reach every root
    for _ in range(H + 1):
        active = node >= 0
        n = node.clamp(min=0)
        ch = children[rows, n]
        best_child = _child_values(value_upper, ch, -torch.inf).amax(dim=1)
        mu_n = mu_ucb[rows, n]
        new_v = torch.where((ch >= 0).any(dim=1), fma(gamma, best_child, mu_n), mu_n)
        value_upper[rows, n] = torch.where(active, new_v, value_upper[rows, n])
        node = torch.where(active, parent[rows, n], node)


class _EpisodeGraph(EpisodeGraph):
    """An OLOP episode (``_episode``) of one signature captured as a CUDA
    graph, and the static buffers it reads and writes: the arena at
    ``capacity`` slots a tree (a plan of N slots uses its first N; a tree
    never writes past its plan's nodes, so the rest changes no bit), the
    params, the start states, the B-value table, gamma, the index vectors,
    the path, and one episode's continuation actions, threshold and env
    noise. Everything that depends on the plan's episodes (the thresholds,
    the arena's fill) enters through these buffers. ``start`` loads a plan's
    inputs and clears the arena; ``replay`` copies in an episode's inputs and
    replays it, capturing it first in the first plan. Every copy is from the
    device. Nothing in a captured episode draws from a generator, so it is
    given none."""

    prefix = "olop"

    def __init__(self, env, params, states0, env_noise, num_actions: int, horizon: int,
                 kl: bool, capacity: int):
        device = states0[0].device
        super().__init__(device)
        B, A, H = states0[0].shape[0], num_actions, horizon
        i64, f32 = torch.int64, torch.float32
        # held: a key that falls back on the env's identity stays unique
        self.env, self.kl, self.capacity = env, kl, capacity
        like = lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
        self.params = type(params)(*map(like, params))
        self.states0 = type(states0)(*map(like, states0))
        self.upper_table = torch.empty(H + 2, dtype=f32, device=device)
        self.gamma = torch.empty((), dtype=f32, device=device)
        self.tree = _arena(B, capacity, A, device)
        self.rows = torch.arange(B, device=device)
        self.offsets = torch.arange(A, device=device)
        self.path = torch.empty((H, B), dtype=i64, device=device)
        self.continuation = torch.empty((H, B), dtype=i64, device=device)
        self.threshold = torch.empty((), dtype=f32, device=device)
        self.env_draws = None if env_noise is None else like(env_noise[0])

    def start(self, params, states0, upper_table, gamma):
        for static, x in zip((*self.params, *self.states0), (*params, *states0)):
            static.copy_(x)
        self.upper_table.copy_(upper_table)
        self.gamma.copy_(gamma)
        self._clear()

    def _clear(self):
        _start(self.tree, self.upper_table, self.kl)

    def replay(self, continuation, threshold, env_draws):
        self.continuation.copy_(continuation)
        self.threshold.copy_(threshold)
        if env_draws is not None:
            self.env_draws.copy_(env_draws)
        super().replay(lambda: _episode(
            self.env, self.params, self.states0, None, self.tree, self.continuation,
            self.threshold, self.env_draws, self.upper_table, self.gamma, self.rows,
            self.offsets, self.path, self.kl))


_kept = Kept(4)


def _episode_graph(env, params, states0, env_noise, num_actions: int, horizon: int, kl: bool,
                   capacity: int) -> _EpisodeGraph:
    """The captured episode of this call's signature: the env
    (``episode_graph.env_key``: an agent's preprocessor makes an env of one
    configuration anew each act, and its acts share one capture), the
    params' and the state's types, shapes and dtypes, the device, the
    action count, the horizon, the bound's form and the env noise's shape. A
    new one, not yet captured, where none is kept or the kept one's arena
    holds fewer than ``capacity`` slots a tree."""
    key = (env_key(env), type(params), tuple((x.shape, x.dtype) for x in params), type(states0),
           tuple((x.shape, x.dtype) for x in states0), states0[0].device, num_actions, horizon,
           kl, None if env_noise is None else (env_noise.shape[1:], env_noise.dtype))
    return _kept.get(key, lambda: _EpisodeGraph(env, params, states0, env_noise, num_actions,
                                                horizon, kl, capacity),
                     lambda kept: kept.capacity >= capacity)


class OLOPAgent(AbstractTreeSearchAgent):
    """OLOP / KL-OLOP agent (reference: olop.py:196-200)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({
            "budget": 100,
            "upper_bound": {
                "type": "kullback-leibler",
                "time": "global",
                "threshold": "4*np.log(time)",
            },
            "continuation_type": "zeros",
        })
        return config

    def make_planner(self):
        budget = max(self.env.action_space.n, self.config["budget"])
        self.config["episodes"], self.config["horizon"] = allocation(
            budget, self.config["gamma"])

    def planner_plan(self, env, observation):
        functional = env.functional
        ub = self.config["upper_bound"]
        if isinstance(ub, str):  # a bare bound name keeps the default threshold and time
            ub = dict(self.default_config()["upper_bound"], type=ub)
        actions, lengths, tree = olop_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]),
            threshold_coeff=parse_threshold(ub.get("threshold", 4.0)),
            ucb_type=ub.get("type", "kullback-leibler"),
            time_global=(ub.get("time", "global") == "global"),
            continuation_uniform=(self.config["continuation_type"] == "uniform"),
            device=self.device)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])
