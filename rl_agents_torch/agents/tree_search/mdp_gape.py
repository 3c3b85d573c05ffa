"""MDP-GapE: best-arm-identification planning for stochastic MDPs, batch-first.

Port of ``rl_agents_tpu/agents/tree_search/mdp_gape.py`` (reference:
tree_search/mdp_gape.py:11-344): decision/chance node alternation with bounded
next-state slots (mdp_gape.py:267-286); per-(s,a,s') reward KL confidence
bounds (mdp_gape.py:200-212); chance-node backups solve the constrained
max-expectation problem for optimistic/pessimistic next-state distributions
(mdp_gape.py:288-305); root action chosen by UGapE: best arm = min gap,
challenger = max UCB, sample the more uncertain (mdp_gape.py:238-249); stop
when ``challenger.U - best.L < accuracy`` (mdp_gape.py:94-110).

Every arena field carries a leading tree axis B and rows are indexed directly;
the JAX package's one-hot masks exist only for the TPU. A tree whose stopping
rule fired freezes under a mask while the others go on, and the planner itself
reads nothing back to the host inside the episode loop: every path is exactly
``horizon`` deep, so the backup is a fixed number of steps. Each chance
backup's constrained solve (``utils/math.py::max_expectation_under_constraint``)
is one launch of a hand-written kernel on a card, which reads nothing back
either; on the CPU its Newton solve reads back once per block of trips.

The JAX package solves each visited node's KL bounds (upper and lower) at
the step that visits it. Here one ``kl_bounds_pair_`` call solves both bounds
of every node of an episode's path ``[H, B]`` after the descent and before
the backup: on a CUDA device one launch per episode. The deferral gives the
same arenas. Nothing reads ``d_mu_ucb`` or ``d_mu_lcb`` before the backup
(the descent reads only the chance nodes' value bounds), and the nodes of one
path lie at distinct depths, so each is updated once per episode and the
call sees the count and sum its step wrote. The threshold is read from a
table over every count a node can reach (at most ``episodes + 1``), made
once per plan: ``reward_threshold`` of each count, or, where the
configuration gives the threshold as ``c*np.log(time)`` (upstream evaluates
``upper_bound.threshold`` with ``time`` the budget's episodes), ``c
log(episodes)`` at every count. The KL solve divides it by the count.

Like the JAX package's loop (``episode <= episodes``), a plan runs up to
``episodes + 1`` episodes. The decision arena is sized for all of them
(``1 + (episodes + 1) * horizon`` nodes), so that no insert can be dropped.

Where every draw is given (the Gumbel tie breaks, and the env's draws or an
env that draws nothing) on a CUDA device, each episode replays one CUDA
graph (``_EpisodeGraph``, as ``mcts_fused.py`` replays an MCTS episode):
its descent, KL bounds, backups (each chance backup's solve one kernel
launch) and stopping rule. The arenas and the buffers an episode reads are
then static, one set for each signature, loaded and cleared at a plan's
start, and the plan returns copies of them; the root's final choice runs
eagerly on them.

Traced (``trainer/profiling.py``), a plan is one ``planner.plan`` span. An
eager episode is a ``gape.descend`` span (expansion, action choice, the
next-state slot's lookup and insert, statistics) holding one
``env.transition`` span a step, then ``gape.bounds`` (the paired KL
launch), ``gape.backup`` (the H decision and H chance backups, their
constrained solves among them) and ``gape.root`` (the root's UGapE gaps and
the stopping rule); a replayed episode is one ``gape.episode`` span (the
draws' copies and the replay). At the end of the plan a ``gape.root`` span
picks the best arm.
``counters["gape.episodes"]`` and ``"gape.steps"`` count the episodes and
their steps (episodes x H), and ``"host.syncs"`` the copies of host tables
and scalars to the device at a plan's start, of draws handed over from
another device or drawn on a generator's, and the Newton solves' read-backs
where they run eagerly (``utils/math.py::newton_iteration``);
``"gape.episode_graph.captures"`` and ``".replays"`` count the episode's
captures and replays.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import allocation
from rl_agents_torch.agents.tree_search.mcts import gumbel, noise_tensor
from rl_agents_torch.agents.tree_search.mcts_fused import _copied, episode_graph_declines
from rl_agents_torch.agents.tree_search.olop import OLOPAgent, parse_threshold
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.ops.kl_bound import kl_bounds_pair_
from rl_agents_torch.trainer.profiling import counters, span
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, max_expectation_under_constraint


class GapETree(NamedTuple):
    # decision nodes: reward stats of the (s,a,s') transition they represent
    d_parent: Any       # [B, Nd] i64 chance parent
    d_depth: Any        # [B, Nd] i64
    d_count: Any        # [B, Nd] i64
    d_cum_reward: Any   # [B, Nd] f32
    d_mu_ucb: Any       # [B, Nd] f32
    d_mu_lcb: Any       # [B, Nd] f32
    d_value_upper: Any  # [B, Nd] f32
    d_value_lower: Any  # [B, Nd] f32
    d_children: Any     # [B, Nd, A] i64 chance ids
    d_done: Any         # [B, Nd] bool
    # chance nodes
    c_parent: Any       # [B, Nc] i64
    c_depth: Any        # [B, Nc] i64
    c_count: Any        # [B, Nc] i64
    c_value_upper: Any  # [B, Nc] f32
    c_value_lower: Any  # [B, Nc] f32
    c_child_keys: Any   # [B, Nc, W] i64 holding 32-bit observation keys
    c_children: Any     # [B, Nc, W] i64 decision ids
    c_n_children: Any   # [B, Nc] i64
    d_used: Any         # [B] i64
    c_used: Any         # [B] i64


def reward_threshold(count, horizon: int, num_actions: int, confidence: float) -> torch.Tensor:
    """BAI threshold (mdp_gape.py:33-36) of the int64 ``count``, float32 on
    its device: 3 log(1 + log(count)) + H log(A) + log(1 / (1 - confidence)),
    with the count clamped to at least 1."""
    f32 = torch.float32
    confidence = torch.tensor(confidence, dtype=f32, device=count.device)
    rest = torch.log(1.0 / (1.0 - confidence))
    actions = float(np.float32(horizon * np.log(num_actions)))
    c = torch.clamp(count.to(f32), min=1.0)
    return 3.0 * torch.log(1.0 + torch.log(c)) + actions + rest


def mdp_gape_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                  num_actions: int, episodes: int, horizon: int, gamma: float, accuracy: float,
                  confidence: float, transition_threshold_coeff: float, width: int = 2,
                  noise=None, env_noise=None, device="cuda",
                  reward_threshold_coeff: float | None = None):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim). Returns ``(best action [B], episodes_used [B], GapETree)``.

    The reward KL bounds' threshold is ``reward_threshold_coeff *
    log(episodes)`` where the coefficient is given (a configured
    ``c*np.log(time)``), else the BAI threshold ``reward_threshold`` of each
    count, which is infinite at ``confidence`` 1.0.

    ``noise`` is Gumbel noise ``[episodes + 1, H, B, A]`` that breaks the ties
    of the optimistic action below the root; without it, it is drawn from
    ``generator``. ``env_noise`` is the env's own noise for every step,
    ``[episodes + 1, H, B, ...]`` (Gumbel ``[..., K]`` for a stochastic finite
    MDP); without it the env draws from ``generator``.
    """
    device = resolve_device(device)
    with span("planner.plan"):
        return _plan(env, params, states0, generator, num_actions, episodes, horizon, gamma,
                     accuracy, confidence, transition_threshold_coeff, width, noise, env_noise,
                     device, reward_threshold_coeff)


def _plan(env, params, states0, generator, num_actions, episodes, horizon, gamma, accuracy,
          confidence, transition_threshold_coeff, width, noise, env_noise, device,
          reward_threshold_coeff):
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    i64, f32 = torch.int64, torch.float32
    # initial value bounds (1 - gamma^(H-depth)) / (1 - gamma), tabulated on
    # the host with scalar float32 powf, as XLA's pow rounds
    g32 = np.float32(gamma)
    upper_table = torch.tensor(
        [(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32) for k in range(H + 1)],
        dtype=f32, device=device)
    gamma = torch.tensor(g32, device=device)
    log_time = torch.log(torch.tensor(float(E), dtype=f32, device=device))
    # the reward threshold of every count a node reaches: one visit an episode
    if reward_threshold_coeff is None:
        threshold_table = reward_threshold(torch.arange(E + 2, device=device), H, A, confidence)
    else:
        threshold_table = (torch.tensor(reward_threshold_coeff, dtype=f32, device=device)
                           * log_time).expand(E + 2).contiguous()
    transition_threshold = torch.tensor(transition_threshold_coeff, dtype=f32,
                                        device=device) * log_time
    # the five host values above (the last the confidence, which
    # ``reward_threshold`` copies, or the reward threshold's coefficient) each
    # wait for the device's queue on their copy, and so does each draw handed
    # over from another device
    counters["host.syncs"] += 5 + sum(_copied(x, device) for x in (noise, env_noise))
    if noise is not None:
        noise = noise_tensor(noise, device)
    elif generator is None:
        raise ValueError("mdp_gape_plan needs a generator or noise")
    if env_noise is not None:
        env_noise = noise_tensor(env_noise, device)

    # a plan whose draws are all given replays each episode from one CUDA
    # graph, on static buffers loaded here; else everything runs eagerly
    replayed = None
    if episode_graph_declines(env, device, noise, env_noise, (*params, *states0)) is None:
        replayed = _episode_graph(env, params, states0, noise, env_noise, A, W, H, E, accuracy)
        replayed.start(params, states0, upper_table, gamma, threshold_table, transition_threshold)
        params, states0, upper_table = replayed.params, replayed.states0, replayed.upper_table
        gamma, threshold_table = replayed.gamma, replayed.threshold_table
        transition_threshold = replayed.transition_threshold
        tree, rows, offsets, slots_w = replayed.tree, replayed.rows, replayed.offsets, replayed.slots
        active, episodes_used, root, path = (replayed.active, replayed.episodes_used,
                                             replayed.root, replayed.path)
    else:
        tree = _arena(B, _decision_nodes(E, H), A, W, device)
        _clear(tree, upper_table[H])
        rows = torch.arange(B, device=device)
        offsets = torch.arange(A, device=device)
        slots_w = torch.arange(W, device=device)
        active = torch.ones(B, dtype=torch.bool, device=device)
        episodes_used = torch.zeros(B, dtype=i64, device=device)
        root = torch.zeros(B, dtype=i64, device=device)
        path = torch.empty((H, B), dtype=i64, device=device)
    (d_parent, d_depth, d_count, d_cum_reward, d_mu_ucb, d_mu_lcb, d_value_upper, d_value_lower,
     d_children, d_done, c_parent, c_depth, c_count, c_value_upper, c_value_lower, c_child_keys,
     c_children, c_n_children, d_used, c_used) = tree
    Nd, Nc = d_parent.shape[1], c_parent.shape[1]

    def init_upper(depth):
        return upper_table[(H - depth).clamp(min=0)]

    def put(arena, index, value, mask):
        """arena[b, index[b]] = value[b] where mask[b]; ``index`` is ``[B]``
        or a tuple of ``[B]`` indices."""
        index = (rows, *index) if isinstance(index, tuple) else (rows, index)
        arena[index] = torch.where(mask, value, arena[index])

    def children_values(values, ch, fill):
        """values[b, ch[b, k]] where ch >= 0, else ``fill``."""
        return torch.where(ch >= 0, values.gather(1, ch.clamp(min=0)), fill)

    def expand_decision(node, active):
        """Create A chance children (mdp_gape.py:162-170)."""
        ch = d_children[rows, node]
        is_leaf = (ch[:, 0] < 0) & active
        leaf_a = is_leaf[:, None]
        ids = c_used[:, None] + offsets
        # trees that do not expand may hold ids past the end: clamp, and
        # write the old values back there
        at = ids.clamp(max=Nc - 1)
        d = d_depth[rows, node][:, None].expand(B, A)
        d_children[rows, node] = torch.where(leaf_a, ids, ch)
        c_parent.scatter_(1, at, torch.where(leaf_a, node[:, None].expand(B, A),
                                             c_parent.gather(1, at)))
        c_depth.scatter_(1, at, torch.where(leaf_a, d, c_depth.gather(1, at)))
        c_value_upper.scatter_(1, at, torch.where(leaf_a, init_upper(d),
                                                  c_value_upper.gather(1, at)))
        c_used.add_(torch.where(is_leaf, A, 0))

    def backup_chance(chance, active):
        """Constrained-expectation Bellman backup (mdp_gape.py:288-305).
        Unfilled next-state slots are placeholders (count 0, mu in [0, 1],
        vacuous value bounds)."""
        ch = c_children[rows, chance]
        d_next = (c_depth[rows, chance] + 1)[:, None].expand(B, W)
        counts = children_values(d_count, ch, 0)
        mu_ucb = children_values(d_mu_ucb, ch, 1.0)
        mu_lcb = children_values(d_mu_lcb, ch, 0.0)
        v_up = torch.where(ch >= 0, d_value_upper.gather(1, ch.clamp(min=0)), init_upper(d_next))
        v_lo = children_values(d_value_lower, ch, 0.0)
        total = torch.clamp(c_count[rows, chance].to(f32), min=1.0)
        p_hat = counts.to(f32) / total[:, None]
        threshold = transition_threshold / total
        # mu + gamma * v compiles to a fused multiply-add in the JAX package
        u_next = fma(gamma, v_up, mu_ucb)
        l_next = fma(gamma, v_lo, mu_lcb)
        # the optimistic and the pessimistic problem in one solve
        p = max_expectation_under_constraint(
            torch.cat([u_next, -l_next]), torch.cat([p_hat, p_hat]),
            torch.cat([threshold, threshold]))
        put(c_value_upper, chance, (p[:B] * u_next).sum(dim=1), active)
        put(c_value_lower, chance, (p[B:] * l_next).sum(dim=1), active)

    def backup_decision(node, active):
        """V = max_a Q over chance children; leaves at horizon get 0
        (mdp_gape.py:214-226)."""
        ch = d_children[rows, node]
        has = (ch >= 0).any(dim=1)
        up = children_values(c_value_upper, ch, -torch.inf).amax(dim=1)
        lo = children_values(c_value_lower, ch, -torch.inf).amax(dim=1)
        put(d_value_upper, node, torch.where(has, up, 0.0), active)
        put(d_value_lower, node, torch.where(has, lo, 0.0), active)

    def root_gaps():
        """UGapE quantities at the root (mdp_gape.py:228-249)."""
        ch0 = d_children[:, 0]
        valid = ch0 >= 0
        up = children_values(c_value_upper, ch0, -torch.inf)
        lo = children_values(c_value_lower, ch0, torch.inf)
        # gap_k = max_{j != k} up_j - lo_k
        top = up.sort(dim=1, descending=True).values
        top0, top1 = top[:, :1], top[:, 1:2]
        shared = (up == top0).sum(dim=1, keepdim=True) > 1
        best_other = torch.where(up == top0, torch.where(shared, top0, top1), top0)
        gaps = torch.where(valid, best_other - lo, torch.inf)
        best = gaps.argmin(dim=1)
        challenger = torch.where(valid & (offsets != best[:, None]), up, -torch.inf).argmax(dim=1)
        pick = lambda x, a: x.gather(1, a[:, None]).squeeze(1)
        uncertainty_best = pick(up, best) - pick(lo, best)
        uncertainty_chal = pick(up, challenger) - pick(lo, challenger)
        selected = torch.where(uncertainty_best >= uncertainty_chal, best, challenger)
        delta = pick(up, challenger) - pick(lo, best)
        return selected, best, challenger, delta

    def descend(g, env_draws, spanned):
        """An episode's path from the root, ``horizon`` steps, into ``path``:
        Gumbel tie breaks ``g`` ``[H, B, A]``, the env's draws ``env_draws``
        ``[H, B, ...]`` or None. A capture records no ``env.transition``
        span (``spanned`` False)."""
        expand_decision(root, active)
        node, state = root, states0
        # sampling rule (mdp_gape.py:183-198): UGapE at the root, which
        # only depth 0 visits, and the optimistic action below it
        selected = root_gaps()[0]
        for h in range(H):
            expand_decision(node, active)
            ch = d_children[rows, node]
            valid = ch >= 0
            ups = children_values(c_value_upper, ch, -torch.inf)
            ties = valid & (ups == ups.amax(dim=1, keepdim=True))
            optimistic = (torch.where(ties, 0.0, -torch.inf) + g[h]).argmax(dim=1)
            action = selected if h == 0 else optimistic
            chance = ch.gather(1, action[:, None]).squeeze(1).clamp(min=0)
            with span("env.transition") if spanned else contextlib.nullcontext():
                out = env.step(params, state, action, generator,
                               None if env_draws is None else env_draws[h])

            # next-state slot by obs key (mdp_gape.py:272-286)
            okey = obs_key(out.obs)
            n = c_n_children[rows, chance]
            match = (c_child_keys[rows, chance] == okey[:, None]) & (slots_w < n[:, None])
            exists = match.any(dim=1)
            insert = ~exists & (n < W) & active
            slot = torch.where(exists, match.to(i64).argmax(dim=1), n.clamp(max=W - 1))
            new_id = d_used.clamp(max=Nd - 1)
            child = torch.where(insert, new_id, c_children[rows, chance, slot].clamp(min=0))
            d_next = c_depth[rows, chance] + 1
            put(c_child_keys, (chance, slot), okey, insert)
            put(c_children, (chance, slot), new_id, insert)
            put(c_n_children, chance, n + 1, insert)
            put(d_parent, new_id, chance, insert)
            put(d_depth, new_id, d_next, insert)
            put(d_value_upper, new_id, init_upper(d_next), insert)
            d_used.add_(insert)

            # statistics updates (mdp_gape.py:85-87, OLOPNode.update semantics)
            done = out.terminated | d_done[rows, child]
            reward = torch.where(done, 0.0, out.reward.to(f32))
            cum = d_cum_reward[rows, child] + reward
            cnt = d_count[rows, child] + 1
            put(c_count, chance, c_count[rows, chance] + 1, active)
            put(d_count, child, cnt, active)
            put(d_cum_reward, child, cum, active)
            put(d_done, child, done, active)
            path[h] = child
            node, state = child, out.state

    def run_episode(g, env_draws, spanned=True):
        """One episode: the descent (``g`` None draws its tie breaks from the
        generator), the path's KL bounds, the backup to the root and the
        root's stopping rule. A capture records no span (``spanned``
        False)."""
        spans = span if spanned else lambda name: contextlib.nullcontext()
        with spans("gape.descend"):
            if g is None:  # drawn on the generator's device, then copied to the planner's
                g = gumbel((H, B, A), generator, device)
                counters["host.syncs"] += generator.device.type != device.type
            descend(g, env_draws, spanned)

        # the KL bounds of the path's nodes (mdp_gape.py:200-212), both in one
        # call, deferred to here: see the module docstring
        with spans("gape.bounds"):
            kl_bounds_pair_(d_mu_ucb, d_mu_lcb, d_cum_reward, d_count, path, threshold_table,
                            active)

        # backup to root (mdp_gape.py:214-226, 288-305): the leaf lies at
        # depth H, so H chance backups between H + 1 decision backups
        with spans("gape.backup"):
            for h in reversed(range(H)):
                backup_decision(path[h], active)
                chance = d_parent[rows, path[h]].clamp(min=0)
                backup_chance(chance, active)
            backup_decision(root, active)

        with spans("gape.root"):
            delta = root_gaps()[3]
            episodes_used.add_(active)
            active.logical_and_(~(delta < accuracy))

    for episode in range(E + 1):
        counters["gape.episodes"] += 1
        g = None if noise is None else noise[episode]
        env_draws = None if env_noise is None else env_noise[episode]
        if replayed is not None:
            with span("gape.episode"):
                replayed.replay(g, env_draws, run_episode)
        else:
            run_episode(g, env_draws)
        counters["gape.steps"] += H

    with span("gape.root"):
        best = root_gaps()[1]
    if replayed is None:
        return best, episodes_used, tree
    # the plan's own arena, cut to its episodes, and copies of the static buffers
    nd = _decision_nodes(E, H)
    cut = {"d": nd, "c": 1 + nd * A}
    return best, episodes_used.clone(), GapETree(*(
        x.clone() if x.dim() == 1 else x[:, :cut[name[0]]].clone()
        for name, x in zip(GapETree._fields, tree)))


def _decision_nodes(episodes: int, horizon: int) -> int:
    """Decision nodes a tree holds: the root and one a step of ``episodes +
    1`` episodes, so that no insert can be dropped."""
    return 1 + (episodes + 1) * horizon


def _arena(B: int, Nd: int, A: int, W: int, device) -> GapETree:
    """Uninitialised arenas of B trees of ``Nd`` decision and ``1 + Nd * A``
    chance nodes (``_clear`` fills them)."""
    Nc = 1 + Nd * A
    i64, f32, bool_ = torch.int64, torch.float32, torch.bool
    shapes = {"d": (B, Nd), "c": (B, Nc)}
    dtypes = dict(d_cum_reward=f32, d_mu_ucb=f32, d_mu_lcb=f32, d_value_upper=f32,
                  d_value_lower=f32, d_done=bool_, c_value_upper=f32, c_value_lower=f32)
    wide = dict(d_children=A, c_child_keys=W, c_children=W)
    fields = {}
    for name in GapETree._fields:
        shape = (B,) if name in ("d_used", "c_used") else shapes[name[0]] + (
            (wide[name],) if name in wide else ())
        fields[name] = torch.empty(shape, dtype=dtypes.get(name, i64), device=device)
    return GapETree(**fields)


# the arenas' values at a plan's start; the value bounds' upper ends hold the
# horizon's bound, ``_clear``'s argument
_FILLS = dict(d_parent=-1, d_depth=0, d_count=0, d_cum_reward=0.0, d_mu_ucb=1.0, d_mu_lcb=0.0,
              d_value_upper=None, d_value_lower=0.0, d_children=-1, d_done=False, c_parent=-1,
              c_depth=0, c_count=0, c_value_upper=None, c_value_lower=0.0, c_child_keys=0,
              c_children=-1, c_n_children=0, d_used=1, c_used=0)


def _clear(tree: GapETree, upper) -> None:
    """Fill the arenas with a plan's start: the fields' constants, and
    ``upper`` (a 0-d tensor) in the upper value bounds."""
    for name, x in zip(GapETree._fields, tree):
        fill = _FILLS[name]
        x.fill_(upper if fill is None else fill)


class _EpisodeGraph:
    """An MDP-GapE episode (``run_episode`` in ``_plan``: the descent, the
    path's KL bounds, the backup and the root's stopping rule) of one
    signature captured as a CUDA graph, and the static buffers it reads and
    writes: the params, the start states, the value bounds' table, gamma,
    the reward thresholds' table (``capacity + 2`` counts; a plan of fewer
    episodes fills its first), the transition threshold, the arenas (sized
    for ``capacity`` episodes: a plan of fewer uses their first nodes), the
    index vectors, the active mask, the episodes run, the root, the path,
    and one episode's draws. ``start`` loads a plan's inputs and clears the
    arenas; ``replay`` copies in an episode's draws and replays the episode,
    capturing it first in the first plan. Every copy is from the device.
    The root's final choice runs eagerly on the same buffers."""

    def __init__(self, env, params, states0, noise, env_noise, num_actions: int, width: int,
                 horizon: int, capacity: int):
        device = states0[0].device
        B, A, W, H = states0[0].shape[0], num_actions, width, horizon
        i64 = torch.int64
        self.env, self.horizon, self.capacity = env, horizon, capacity  # the key holds id(env)
        like = lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
        self.params = type(params)(*map(like, params))
        self.states0 = type(states0)(*map(like, states0))
        self.upper_table = torch.empty(H + 1, dtype=torch.float32, device=device)
        self.gamma = torch.empty((), dtype=torch.float32, device=device)
        self.threshold_table = torch.zeros(capacity + 2, dtype=torch.float32, device=device)
        self.transition_threshold = torch.empty((), dtype=torch.float32, device=device)
        self.tree = _arena(B, _decision_nodes(capacity, H), A, W, device)
        self.rows = torch.arange(B, device=device)
        self.offsets = torch.arange(A, device=device)
        self.slots = torch.arange(W, device=device)
        self.active = torch.empty(B, dtype=torch.bool, device=device)
        self.episodes_used = torch.empty(B, dtype=i64, device=device)
        self.root = torch.zeros(B, dtype=i64, device=device)
        self.path = torch.empty((H, B), dtype=i64, device=device)
        self.g = like(noise[0])
        self.env_draws = None if env_noise is None else like(env_noise[0])
        self.graph = self.counted = None

    def start(self, params, states0, upper_table, gamma, threshold_table, transition_threshold):
        for static, x in zip((*self.params, *self.states0), (*params, *states0)):
            static.copy_(x)
        self.upper_table.copy_(upper_table)
        self.gamma.copy_(gamma)
        self.threshold_table[:threshold_table.numel()].copy_(threshold_table)
        self.transition_threshold.copy_(transition_threshold)
        self._clear()

    def _clear(self):
        _clear(self.tree, self.upper_table[self.horizon])
        self.active.fill_(True)
        self.episodes_used.zero_()

    def replay(self, g, env_draws, run_episode):
        self.g.copy_(g)
        if env_draws is not None:
            self.env_draws.copy_(env_draws)
        if self.graph is None:
            self._capture(run_episode)
        self.graph.replay()
        counters.update(self.counted)
        counters["gape.episode_graph.replays"] += 1

    def _capture(self, run_episode):
        """Capture the episode on the current device, after one run on a side
        stream (which builds and loads what it launches), from the inputs
        loaded at a plan's first episode; then clear the arenas the run
        wrote. The run and the capture count only as one capture, and
        ``counted`` keeps what the captured episode counted."""
        run = lambda: run_episode(self.g, self.env_draws, spanned=False)
        before = counters.copy()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = counters.copy()
        with torch.cuda.graph(graph):
            run()
        self.graph, self.counted = graph, counters - warm
        counters.subtract(counters - before)
        counters["gape.episode_graph.captures"] += 1
        self._clear()


# captures kept, the most recently used last; each holds its arenas and its graph's memory
_GRAPHS_KEPT = 4
_graphs: OrderedDict = OrderedDict()


def _episode_graph(env, params, states0, noise, env_noise, num_actions: int, width: int,
                   horizon: int, episodes: int, accuracy: float) -> _EpisodeGraph:
    """The captured episode of this call's signature: the env (by identity),
    the params' and the state's types, shapes and dtypes, the device, the
    action count, the slot count, the horizon, the draws' shapes and the
    accuracy (the stopping rule's constant). A new one, not yet captured,
    where none is kept or the kept one's arenas hold fewer than
    ``episodes``."""
    key = (id(env), type(params), tuple((x.shape, x.dtype) for x in params), type(states0),
           tuple((x.shape, x.dtype) for x in states0), states0[0].device, num_actions, width,
           horizon, noise.shape[1:], None if env_noise is None else (env_noise.shape[1:],
                                                                      env_noise.dtype),
           float(accuracy))
    kept = _graphs.pop(key, None)
    if kept is None or kept.capacity < episodes:
        kept = _EpisodeGraph(env, params, states0, noise, env_noise, num_actions, width, horizon,
                             episodes)
    _graphs[key] = kept
    while len(_graphs) > _GRAPHS_KEPT:
        _graphs.popitem(last=False)
    return kept


class MDPGapEAgent(OLOPAgent):
    """(reference: mdp_gape.py:316-344)"""

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "accuracy": 1.0,
            "confidence": 0.9,
            "continuation_type": "uniform",
            "horizon_from_accuracy": False,
            "max_next_states_count": 1,
            "upper_bound": {
                "type": "kullback-leibler",
                "time": "global",
                "transition_threshold": "0.1*np.log(time)",
            },
        })
        return cfg

    def make_planner(self):
        if self.config.get("horizon_from_accuracy"):
            self.config["horizon"] = int(np.ceil(
                np.log(self.config["accuracy"] * (1 - self.config["gamma"]) / 2)
                / np.log(self.config["gamma"])))
            self.config["episodes"] = self.config["budget"] // self.config["horizon"]
            if self.config["episodes"] <= 1:
                raise ValueError("budget too small for the horizon that the accuracy asks for")
        else:
            budget = max(self.env.action_space.n, self.config["budget"])
            self.config["episodes"], self.config["horizon"] = allocation(
                budget, self.config["gamma"])

    def planner_plan(self, env, observation):
        functional = env.functional
        # a configured c*np.log(time), else the BAI threshold (upstream's default)
        threshold = self.config["upper_bound"].get("threshold")
        best, episodes_used, tree = mdp_gape_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]), accuracy=float(self.config["accuracy"]),
            confidence=float(self.config["confidence"]),
            transition_threshold_coeff=parse_threshold(
                self.config["upper_bound"].get("transition_threshold", 0.1)),
            width=max(int(self.config["max_next_states_count"]), 1), device=self.device,
            reward_threshold_coeff=None if threshold is None else parse_threshold(threshold))
        self.last_plan_data = tree
        self.budget_used = int(episodes_used[0]) * int(self.config["horizon"])
        return [int(best[0])]
