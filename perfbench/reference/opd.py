"""Plain reference of Optimistic Planning for Deterministic systems (OPD).

Hren and Munos, "Optimistic planning of deterministic systems" (EWRL 2008),
as eleurent/rl-agents implements it (``agents/tree_search/deterministic.py``):
each of ``expansions`` rounds expands the leaf with the largest upper bound
(the earliest-created one among equals) by stepping the model once per
action; a child at depth d gets

    value_lower = value_lower(parent) + gamma^(d-1) * reward
    value_upper = value_lower + gamma^d / (1 - gamma)

(a terminal child: both ``value_lower + terminal_reward * gamma^d / (1 -
gamma)``). Interior nodes then take the max of their children's bounds and
count their subtree, and the plan descends from the root by the largest
lower bound, ties broken by the given Gumbel noise.

Many trees at once, one row each, in fixed arenas of ``1 + expansions * A``
nodes whose child blocks are written at round-indexed bases. Plain PyTorch
over the env's plain reference; imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.rounding import fused


class Tree(NamedTuple):
    parent: torch.Tensor       # [B, N] int64
    action: torch.Tensor       # [B, N] int64
    depth: torch.Tensor        # [B, N] int64
    children: torch.Tensor     # [B, N, A] int64, -1 where absent
    reward: torch.Tensor       # [B, N]
    done: torch.Tensor         # [B, N] bool
    value_lower: torch.Tensor  # [B, N]
    value_upper: torch.Tensor  # [B, N]
    leaf: torch.Tensor         # [B, N] bool
    count: torch.Tensor        # [B, N] int64 subtree size
    used: torch.Tensor         # [B] int64
    states: tuple              # the env's scene, [B, N, ...] each field


def discounts(gamma: float, size: int, device, dtype):
    """gamma ** k for k < size, each a scalar float32 power."""
    g = np.float32(gamma)
    return torch.tensor([g ** np.float32(k) for k in range(size)], dtype=torch.float32,
                        device=device).to(dtype)


def plan(env, model, scenes, noise, *, num_actions: int,
         expansions: int, gamma: float, terminal_reward: float = 0.0, dtype=torch.float32):
    """Plan one tree from each scene. ``noise [P, B, A]`` breaks the plan's
    ties. ``env`` is the env's plain reference (its ``transition``), ``model``
    its parameters, ``scenes`` a named tuple of ``[B, ...]`` fields. Returns
    ``(actions [B, P] with -1 past the plan, lengths [B], Tree)``."""
    A, R = num_actions, expansions
    B = scenes[0].shape[0]
    N = 1 + R * A
    dev = scenes[0].device
    Scene = type(scenes)
    i64 = torch.int64
    rows = torch.arange(B, device=dev)
    offsets = torch.arange(A, device=dev)

    def full(shape, fill, kind):
        return torch.full(shape, fill, dtype=kind, device=dev)

    def arena(x):
        out = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=dev)
        out[:, 0] = x
        return out

    parent, action, depth = full((B, N), -1, i64), full((B, N), -1, i64), full((B, N), 0, i64)
    children = full((B, N, A), -1, i64)
    reward, done = full((B, N), 0.0, dtype), full((B, N), False, torch.bool)
    value_lower, value_upper = full((B, N), 0.0, dtype), full((B, N), 0.0, dtype)
    leaf = full((B, N), False, torch.bool)
    leaf[:, 0] = True
    count = full((B, N), 0, i64)
    count[:, 0] = 1
    states = Scene(*(arena(x) for x in scenes))

    g32 = np.float32(gamma)
    one_minus_gamma = torch.tensor(np.float32(1) - g32, device=dev).to(dtype)
    terminal = torch.tensor(np.float32(terminal_reward), device=dev).to(dtype)
    discount = discounts(gamma, N + 1, dev, dtype)

    for r in range(R):
        node = torch.where(leaf, value_upper, -torch.inf).argmax(dim=1)
        base = 1 + r * A
        block = slice(base, base + A)
        here = Scene(*(x[rows, node].repeat_interleave(A, dim=0) for x in states))
        nxt, rew, crashed = env.transition(model, here, offsets.repeat(B), dtype)
        d = depth[rows, node] + 1
        rew = rew.to(dtype).reshape(B, A)
        child_done = crashed.reshape(B, A) | done[rows, node][:, None]
        vl = fused(discount[d - 1][:, None], rew, value_lower[rows, node][:, None], dtype)
        horizon = discount[d][:, None]
        vu = vl + horizon / one_minus_gamma
        end = vl + terminal * horizon / one_minus_gamma
        vl, vu = torch.where(child_done, end, vl), torch.where(child_done, end, vu)
        for field, new in zip(states, nxt):
            field[:, block] = new.reshape((B, A) + new.shape[1:])
        parent[:, block] = node[:, None]
        action[:, block] = offsets
        depth[:, block] = d[:, None]
        children[rows, node] = base + offsets
        reward[:, block] = rew
        done[:, block] = child_done
        value_lower[:, block] = vl
        value_upper[:, block] = vu
        leaf[rows, node] = False
        leaf[:, block] = True
        count[:, block] = 1
    used = full((B,), 1 + R * A, i64)

    # interior bounds and subtree counts, bottom up to a fixed point
    valid = children >= 0
    index = children.clamp(min=0).reshape(B, N * A)
    interior = valid.any(dim=2)

    def best(values):
        return torch.where(valid, values.gather(1, index).reshape(B, N, A), -torch.inf).amax(dim=2)

    for _ in range(R + 1):
        sub = torch.where(valid, count.gather(1, index).reshape(B, N, A), 0).sum(dim=2)
        new_vl = torch.where(interior, best(value_lower), value_lower)
        new_vu = torch.where(interior, best(value_upper), value_upper)
        new_count = torch.where(interior, 1 + sub, count)
        changed = bool(((new_vl != value_lower) | (new_vu != value_upper)
                        | (new_count != count)).any())
        value_lower, value_upper, count = new_vl, new_vu, new_count
        if not changed:
            break

    # the plan: greedy by lower bound, random among equals
    node = torch.zeros(B, dtype=i64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    actions = []
    for step in range(noise.shape[0]):
        ch = children[rows, node]
        ok = ch >= 0
        vals = torch.where(ok, value_lower.gather(1, ch.clamp(min=0)), -torch.inf)
        ties = ok & (vals == vals.amax(dim=1, keepdim=True))
        pick = (torch.where(ties, 0.0, -torch.inf) + noise[step]).argmax(dim=1)
        live = live & ok.any(dim=1)
        node = torch.where(live, ch.gather(1, pick[:, None]).squeeze(1), node)
        actions.append(torch.where(live, pick, -1))
    actions = torch.stack(actions, dim=1)
    tree = Tree(parent, action, depth, children, reward, done, value_lower, value_upper, leaf,
                count, used, states)
    return actions, (actions >= 0).sum(dim=1), tree


def root_values(tree: Tree):
    """The lower bound of each root child ``[B, A]`` (-inf where absent): the
    value of each first action that the plan's first step compares."""
    ch = tree.children[:, 0]
    return torch.where(ch >= 0, tree.value_lower.gather(1, ch.clamp(min=0)), -torch.inf)
