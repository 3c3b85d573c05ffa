"""Plain reference of Open-Loop Optimistic Planning with KL upper bounds
(KL-OLOP).

Bubeck and Munos, "Open loop optimistic planning" (COLT 2010), and Leurent
and Maillard, "Practical open-loop optimistic planning" (ECML-PKDD 2019),
as eleurent/rl-agents implements it (``agents/tree_search/olop.py``). The
budget is spent in M episodes of horizon L. An episode descends the tree of
action sequences from the root, each step to the child of largest B-value
(a leaf is first given its A children, each with the B-value ``(1 -
gamma^(L + 1 - depth)) / (1 - gamma)``, and a step from a leaf takes the
given uniform random action), steps the model, and adds the reward (0 once
the sequence has crashed) to the child's sum and count. Then each node of
the path gets its reward's KL upper bound ``mu_ucb`` at the threshold ``c
log M``, and the path's B-values are backed up to the root,
``B = mu_ucb + gamma * max over children of B``. The plan descends by the
largest count, ties by B-value.

Many trees at once, one row each. Plain PyTorch over
the env's plain reference and ``reference/kl.py``; imports nothing of the
program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import kl
from perfbench.reference.rounding import fused


class Tree(NamedTuple):
    parent: torch.Tensor       # [B, N] int64
    children: torch.Tensor     # [B, N, A] int64
    depth: torch.Tensor        # [B, N] int64
    count: torch.Tensor        # [B, N] int64
    cum_reward: torch.Tensor   # [B, N]
    mu_ucb: torch.Tensor       # [B, N]
    value_upper: torch.Tensor  # [B, N]
    done: torch.Tensor         # [B, N] bool
    used: torch.Tensor         # [B] int64


def plan(env, model, scenes, random_actions, *, num_actions: int, episodes: int, horizon: int,
         gamma: float, threshold_coeff: float, dtype=torch.float32):
    """Plan one tree from each scene with the continuation actions
    ``random_actions [M, L, B]``. ``env`` is the env's plain reference (its
    ``transition``), ``model`` its parameters, ``scenes`` a named tuple of
    ``[B, ...]`` fields. Returns ``(actions [B, L] with -1 past the plan,
    lengths [B], Tree)``."""
    A, H, E = num_actions, horizon, episodes
    B = scenes[0].shape[0]
    N = 1 + E * H * A
    dev = scenes[0].device
    i64 = torch.int64
    g32 = np.float32(gamma)
    upper_table = torch.tensor([(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32)
                                for k in range(H + 2)], dtype=torch.float32, device=dev).to(dtype)
    g = torch.tensor(g32, device=dev).to(dtype)
    rows = torch.arange(B, device=dev)
    offsets = torch.arange(A, device=dev)

    parent = torch.full((B, N), -1, dtype=i64, device=dev)
    children = torch.full((B, N, A), -1, dtype=i64, device=dev)
    depth = torch.zeros((B, N), dtype=i64, device=dev)
    count = torch.zeros((B, N), dtype=i64, device=dev)
    cum_reward = torch.zeros((B, N), dtype=dtype, device=dev)
    mu_ucb = torch.full((B, N), 1.0, dtype=dtype, device=dev)
    value_upper = torch.zeros((B, N), dtype=dtype, device=dev)
    value_upper[:, 0] = upper_table[H + 1]
    done = torch.zeros((B, N), dtype=torch.bool, device=dev)
    used = torch.ones(B, dtype=i64, device=dev)
    thresholds = threshold_coeff * torch.log(torch.full((E,), float(E), device=dev).to(dtype))
    random_actions = random_actions.to(device=dev, dtype=i64)

    def of_children(values, ch, fill):
        return torch.where(ch >= 0, values.gather(1, ch.clamp(min=0)), fill)

    path = torch.empty((H, B), dtype=i64, device=dev)
    for episode in range(E):
        node = torch.zeros(B, dtype=i64, device=dev)
        scene = scenes
        for h in range(H):
            is_leaf = children[rows, node, 0] < 0
            ids = used[:, None] + offsets
            children[rows, node] = torch.where(is_leaf[:, None], ids, children[rows, node])
            slots = ids.clamp(max=N - 1)
            d = (depth[rows, node] + 1)[:, None].expand(B, A)
            new = is_leaf[:, None]
            parent.scatter_(1, slots, torch.where(new, node[:, None].expand(B, A),
                                                  parent.gather(1, slots)))
            depth.scatter_(1, slots, torch.where(new, d, depth.gather(1, slots)))
            value_upper.scatter_(1, slots, torch.where(new, upper_table[H + 1 - d],
                                                       value_upper.gather(1, slots)))
            used = used + torch.where(is_leaf, A, 0)
            ch = children[rows, node]
            best = of_children(value_upper, ch, -torch.inf).argmax(dim=1)
            act = torch.where(is_leaf, random_actions[episode, h], best)
            scene, rew, crashed = env.transition(model, scene, act, dtype)
            child = ch.gather(1, act[:, None]).squeeze(1)
            child_done = crashed | done[rows, child]
            cum_reward[rows, child] = cum_reward[rows, child] + torch.where(child_done, 0.0,
                                                                            rew.to(dtype))
            count[rows, child] = count[rows, child] + 1
            done[rows, child] = child_done
            path[h] = child
            node = child

        per_tree = path.t()
        bound = kl.upper_bound(cum_reward.gather(1, per_tree),
                               count.gather(1, per_tree).to(dtype), thresholds[episode])
        mu_ucb.scatter_(1, per_tree, bound)

        for _ in range(H + 1):
            active = node >= 0
            n = node.clamp(min=0)
            ch = children[rows, n]
            best_child = of_children(value_upper, ch, -torch.inf).amax(dim=1)
            mu_n = mu_ucb[rows, n]
            backed = torch.where((ch >= 0).any(dim=1), fused(g, best_child, mu_n, dtype),
                                 mu_n)
            value_upper[rows, n] = torch.where(active, backed, value_upper[rows, n])
            node = torch.where(active, parent[rows, n], node)

    node = torch.zeros(B, dtype=i64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    actions = []
    for _ in range(H):
        ch = children[rows, node]
        ok = ch >= 0
        counts = of_children(count, ch, -1)
        tie = ok & (counts == counts.amax(dim=1, keepdim=True))
        pick = torch.where(tie, of_children(value_upper, ch, 0.0), -torch.inf).argmax(dim=1)
        live = live & ok.any(dim=1)
        node = torch.where(live, ch.gather(1, pick[:, None]).squeeze(1), node)
        actions.append(torch.where(live, pick, -1))
    actions = torch.stack(actions, dim=1)
    tree = Tree(parent, children, depth, count, cum_reward, mu_ucb, value_upper, done, used)
    return actions, (actions >= 0).sum(dim=1), tree
