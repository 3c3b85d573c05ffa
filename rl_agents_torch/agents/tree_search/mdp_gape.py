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
``horizon`` deep, so the backup is a fixed number of steps. The one read-back
is the Newton solve's of each chance backup, once per block of trips
(``utils/math.py::newton_iteration``).

The JAX package solves each visited node's KL bounds (upper and lower) at
the step that visits it. Here one ``kl_bounds_pair_`` call solves both bounds
of every node of an episode's path ``[H, B]`` after the descent and before
the backup: on a CUDA device one launch per episode. The deferral gives the
same arenas. Nothing reads ``d_mu_ucb`` or ``d_mu_lcb`` before the backup
(the descent reads only the chance nodes' value bounds), and the nodes of one
path lie at distinct depths, so each is updated once per episode and the
call sees the count and sum its step wrote. The count-dependent threshold is
read from a table of ``reward_threshold`` over every count a node can reach
(at most ``episodes + 1``), made once per plan by the same function.

Like the JAX package's loop (``episode <= episodes``), a plan runs up to
``episodes + 1`` episodes. The decision arena is sized for all of them
(``1 + (episodes + 1) * horizon`` nodes), so that no insert can be dropped.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import allocation
from rl_agents_torch.agents.tree_search.mcts import gumbel, noise_tensor
from rl_agents_torch.agents.tree_search.olop import OLOPAgent, parse_threshold
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.ops.kl_bound import kl_bounds_pair_
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
                  noise=None, env_noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim). Returns ``(best action [B], episodes_used [B], GapETree)``.

    ``noise`` is Gumbel noise ``[episodes + 1, H, B, A]`` that breaks the ties
    of the optimistic action below the root; without it, it is drawn from
    ``generator``. ``env_noise`` is the env's own noise for every step,
    ``[episodes + 1, H, B, ...]`` (Gumbel ``[..., K]`` for a stochastic finite
    MDP); without it the env draws from ``generator``.
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    Nd = 1 + (E + 1) * H
    Nc = 1 + Nd * A
    i64, f32 = torch.int64, torch.float32
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    slots_w = torch.arange(W, device=device)
    # initial value bounds (1 - gamma^(H-depth)) / (1 - gamma), tabulated on
    # the host with scalar float32 powf, as XLA's pow rounds
    g32 = np.float32(gamma)
    upper_table = torch.tensor(
        [(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32) for k in range(H + 1)],
        dtype=f32, device=device)
    gamma = torch.tensor(g32, device=device)
    # the reward threshold of every count a node reaches: one visit an episode
    threshold_table = reward_threshold(torch.arange(E + 2, device=device), H, A, confidence)
    transition_threshold = (torch.tensor(transition_threshold_coeff, dtype=f32, device=device)
                            * torch.log(torch.tensor(float(E), dtype=f32, device=device)))
    if noise is not None:
        noise = noise_tensor(noise, device)
    elif generator is None:
        raise ValueError("mdp_gape_plan needs a generator or noise")
    if env_noise is not None:
        env_noise = noise_tensor(env_noise, device)

    def init_upper(depth):
        return upper_table[(H - depth).clamp(min=0)]

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    tree = GapETree(
        d_parent=full((B, Nd), -1, i64), d_depth=full((B, Nd), 0, i64),
        d_count=full((B, Nd), 0, i64), d_cum_reward=full((B, Nd), 0.0, f32),
        d_mu_ucb=full((B, Nd), 1.0, f32), d_mu_lcb=full((B, Nd), 0.0, f32),
        d_value_upper=upper_table[H].expand(B, Nd).clone(), d_value_lower=full((B, Nd), 0.0, f32),
        d_children=full((B, Nd, A), -1, i64), d_done=full((B, Nd), False, torch.bool),
        c_parent=full((B, Nc), -1, i64), c_depth=full((B, Nc), 0, i64),
        c_count=full((B, Nc), 0, i64),
        c_value_upper=upper_table[H].expand(B, Nc).clone(), c_value_lower=full((B, Nc), 0.0, f32),
        c_child_keys=full((B, Nc, W), 0, i64), c_children=full((B, Nc, W), -1, i64),
        c_n_children=full((B, Nc), 0, i64),
        d_used=full((B,), 1, i64), c_used=full((B,), 0, i64))
    (d_parent, d_depth, d_count, d_cum_reward, d_mu_ucb, d_mu_lcb, d_value_upper, d_value_lower,
     d_children, d_done, c_parent, c_depth, c_count, c_value_upper, c_value_lower, c_child_keys,
     c_children, c_n_children, d_used, c_used) = tree

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

    active = torch.ones(B, dtype=torch.bool, device=device)
    episodes_used = torch.zeros(B, dtype=i64, device=device)
    root = torch.zeros(B, dtype=i64, device=device)
    path = torch.empty((H, B), dtype=i64, device=device)
    for episode in range(E + 1):
        g = noise[episode] if noise is not None else gumbel((H, B, A), generator, device)
        expand_decision(root, active)
        node, state = root, states0
        # sampling rule (mdp_gape.py:183-198): UGapE at the root, which only
        # depth 0 visits, and the optimistic action below it
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
            out = env.step(params, state, action, generator,
                           None if env_noise is None else env_noise[episode, h])

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

        # the KL bounds of the path's nodes (mdp_gape.py:200-212), both in one
        # call, deferred to here: see the module docstring
        kl_bounds_pair_(d_mu_ucb, d_mu_lcb, d_cum_reward, d_count, path, threshold_table, active)

        # backup to root (mdp_gape.py:214-226, 288-305): the leaf lies at
        # depth H, so H chance backups between H + 1 decision backups
        for h in reversed(range(H)):
            backup_decision(path[h], active)
            chance = d_parent[rows, path[h]].clamp(min=0)
            backup_chance(chance, active)
        backup_decision(root, active)

        delta = root_gaps()[3]
        episodes_used += active
        active = active & ~(delta < accuracy)

    best = root_gaps()[1]
    return best, episodes_used, tree


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
        best, episodes_used, tree = mdp_gape_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]), accuracy=float(self.config["accuracy"]),
            confidence=float(self.config["confidence"]),
            transition_threshold_coeff=parse_threshold(
                self.config["upper_bound"].get("transition_threshold", 0.1)),
            width=max(int(self.config["max_next_states_count"]), 1), device=self.device)
        self.last_plan_data = tree
        self.budget_used = int(episodes_used[0]) * int(self.config["horizon"])
        return [int(best[0])]
