"""Plain reference of Monte-Carlo Tree Search with UCT-style selection (MCTS).

Kocsis and Szepesvari, "Bandit based Monte-Carlo planning" (ECML 2006), as
eleurent/rl-agents implements it (``agents/tree_search/mcts.py``, the node
in ``agents/tree_search/abstract.py``). The budget is spent in E episodes of
horizon H, each from the root's scene:

- descend while the node has children, its depth is below H and the last
  step did not end in a terminal state, each step to the child of largest
  ``value + T * |children| * prior / (count + 1)``, ties broken at random;
- expand the node reached, if it has no children, its depth is below H and
  its state is not terminal (the root always), into one child an action,
  each with its prior probability;
- if its state is not terminal, roll out from its depth to H with the
  rollout policy's random action, stopping at a terminal state;
- the episode's return ``sum_h gamma^h r_h`` (descent and rollout steps,
  the terminal step's reward included) updates the count and the running
  mean value of every node from the one reached up to the root.

The plan descends from the root by the largest count, ties by value, the
first action of those.

Every random choice is an argmax over given Gumbel draws ``[E, H, 2, A,
B]``: at step h of episode e, a tie of the descent goes to the tied child of
largest ``draws[e, h, 0]``, and the rollout action is the argmax of the
rollout policy's log-probabilities plus ``draws[e, h, 1]``.

Two choices follow the program where the published code leaves them open.
Slots: the node expanded in episode e takes the slots ``1 + e * A`` to ``e *
A + A`` for its children (the program's documented arena layout, adopted
because the comparison is slot by slot; the numbering is not semantics, and
``used`` counts the nodes allocated, ``1 + A x expansions``). Children:
every node gets all A actions under the prior it is given, where upstream's
``random_available`` prior gives a highway node only the actions its scene
allows.

Many trees at once, one row each, over the env's plain reference. The
program fuses no product into a sum here, so each operation rounds once on
its own. Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Tree(NamedTuple):
    parent: torch.Tensor    # [B, N] int64, -1 for the root and unallocated slots
    children: torch.Tensor  # [B, N, A] int64, -1 where absent
    count: torch.Tensor     # [B, N] int64 visits
    value: torch.Tensor     # [B, N] mean return
    prior: torch.Tensor     # [B, N] prior probability (1 at the root)
    used: torch.Tensor      # [B] int64 nodes allocated


def plan(env, model, scenes, draws, prior_probs, rollout_probs, *, num_actions: int,
         episodes: int, horizon: int, gamma: float, temperature: float,
         dtype=torch.float32):
    """Plan one tree from each scene. ``env`` is the env's plain reference
    (its ``transition``), ``model`` its parameters, ``scenes`` a named tuple
    of ``[B, ...]`` fields, ``draws`` the Gumbel draws ``[E, H, 2, A, B]``,
    ``prior_probs`` and ``rollout_probs`` ``[A]``. Returns ``(actions [B, H]
    with -1 past the plan, lengths [B], Tree)``."""
    A, H, E = num_actions, horizon, episodes
    B = scenes[0].shape[0]
    N = 1 + E * A
    dev = scenes[0].device
    i64 = torch.int64
    g32 = np.float32(gamma)
    discount = torch.tensor([g32 ** np.float32(k) for k in range(H)], dtype=torch.float32,
                            device=dev).to(dtype)
    T = torch.tensor(temperature, dtype=torch.float32, device=dev).to(dtype)
    prior_probs = prior_probs.to(device=dev, dtype=torch.float32).to(dtype)
    rollout_logits = torch.log(rollout_probs.to(device=dev, dtype=torch.float32)).to(dtype)
    draws = draws.to(device=dev, dtype=torch.float32).to(dtype)
    rows = torch.arange(B, device=dev)
    actions_ = torch.arange(A, device=dev)

    parent = torch.full((B, N), -1, dtype=i64, device=dev)
    children = torch.full((B, N, A), -1, dtype=i64, device=dev)
    count = torch.zeros((B, N), dtype=i64, device=dev)
    value = torch.zeros((B, N), dtype=dtype, device=dev)
    prior = torch.ones((B, N), dtype=dtype, device=dev)
    used = torch.ones(B, dtype=i64, device=dev)

    def step(scene, action, active):
        """The env's step where ``active``; elsewhere the scene stays and
        earns nothing."""
        nxt, reward, crashed = env.transition(model, scene, action, dtype)
        mask = lambda x: active.reshape((-1,) + (1,) * (x.dim() - 1))
        scene = type(scene)(*(torch.where(mask(n), n, o) for n, o in zip(nxt, scene)))
        return scene, torch.where(active, reward.to(dtype), 0.0), active & crashed

    for episode in range(E):
        node = torch.zeros(B, dtype=i64, device=dev)
        depth = torch.zeros(B, dtype=i64, device=dev)
        terminal = torch.zeros(B, dtype=torch.bool, device=dev)
        total = torch.zeros(B, dtype=dtype, device=dev)
        scene = scenes

        # descend: at step h every moving tree is at depth h
        for h in range(H):
            ch = children[rows, node]
            has = ch >= 0
            moving = has.any(dim=1) & ~terminal
            at = ch.clamp(min=0)
            n_children = has.sum(dim=1, keepdim=True).to(dtype)
            scores = torch.where(has, value.gather(1, at) + T * n_children * prior.gather(1, at)
                                 / (count.gather(1, at).to(dtype) + 1.0), -torch.inf)
            tied = has & (scores == scores.amax(dim=1, keepdim=True))
            action = torch.where(tied, draws[episode, h, 0].t(), -torch.inf).argmax(dim=1)
            scene, reward, ended = step(scene, action, moving)
            total = torch.where(moving, total + discount[h] * reward, total)
            node = torch.where(moving, ch.gather(1, action[:, None]).squeeze(1), node)
            depth = depth + moving.to(i64)
            terminal = terminal | ended

        # expand the node reached
        leaf = children[rows, node, 0] < 0
        expand = leaf & (depth < H) & (~terminal | (node == 0))
        slots = 1 + episode * A + actions_
        children[rows, node] = torch.where(expand[:, None], slots, children[rows, node])
        parent[:, slots] = torch.where(expand[:, None], node[:, None], parent[:, slots])
        prior[:, slots] = torch.where(expand[:, None], prior_probs, prior[:, slots])
        used = used + A * expand.to(i64)

        # roll out from the depth reached to the horizon
        for h in range(H):
            rolling = (depth <= h) & ~terminal
            action = (rollout_logits + draws[episode, h, 1].t()).argmax(dim=1)
            scene, reward, ended = step(scene, action, rolling)
            total = torch.where(rolling, total + discount[h] * reward, total)
            terminal = terminal | ended

        # the return updates the branch, from the node reached up to the root
        at = node
        for _ in range(H + 1):
            on = at >= 0
            n = at.clamp(min=0)
            visits = count[rows, n] + 1
            mean = value[rows, n]
            count[rows, n] = torch.where(on, visits, count[rows, n])
            value[rows, n] = torch.where(on, mean + (total - mean) / visits.to(dtype), mean)
            at = torch.where(on, parent[rows, n], at)

    node = torch.zeros(B, dtype=i64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    actions = []
    for _ in range(H):
        ch = children[rows, node]
        has = ch >= 0
        at = ch.clamp(min=0)
        counts = torch.where(has, count.gather(1, at), -1)
        best = has & (counts == counts.amax(dim=1, keepdim=True))
        pick = torch.where(best, value.gather(1, at), -torch.inf).argmax(dim=1)
        live = live & has.any(dim=1)
        node = torch.where(live, ch.gather(1, pick[:, None]).squeeze(1), node)
        actions.append(torch.where(live, pick, -1))
    actions = torch.stack(actions, dim=1)
    tree = Tree(parent, children, count, value, prior, used)
    return actions, (actions >= 0).sum(dim=1), tree
