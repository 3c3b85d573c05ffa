"""Optimistic Planning for Deterministic systems (OPD), batch-first.

Port of ``rl_agents_tpu/agents/tree_search/deterministic.py`` (reference:
tree_search/deterministic.py:9-139). The reference's Python object tree with
one env deep-copy per child becomes a fixed-capacity node arena per tree plus a
stacked env state; one expansion round is a masked argmax leaf selection, one
env transition over all trees and actions, and the child block written at a
round-indexed slot base shared by the whole batch. Interior bounds and subtree
counts are consolidated once after the rounds.

Every arena field carries a leading tree axis B and rows are indexed directly,
so the single-tree planner, its ``vmap`` and the fused batch planner of the
JAX package are one program here: ``opd_plan`` plans B trees,
``opd_plan_batch`` is the same planner under the fused planner's noise layout.

Bound math preserved exactly (deterministic.py:45-62):
    value_lower(child) = value_lower(parent) + gamma^(d-1) * r
    value_upper(child) = value_lower(child) + gamma^d / (1 - gamma)
    terminal children: both collapse to value_lower + terminal_reward * gamma^d/(1-gamma)

The env is stepped with its ``null_noise``: the planner is deterministic and
plans against one frozen outcome of the env's draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import (
    AbstractTreeSearchAgent,
    arena_subtree_gather,
)
from rl_agents_torch.agents.tree_search.mcts import discount_table
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import gumbel, noise_tensor
from rl_agents_torch.utils.pcg64 import pcg64_choice


class OPDTree(NamedTuple):
    parent: Any        # [B, N] i64
    action: Any        # [B, N] i64 action from parent
    depth: Any         # [B, N] i64
    children: Any      # [B, N, A] i64, -1 when absent
    reward: Any        # [B, N] f32
    done: Any          # [B, N] bool
    value_lower: Any   # [B, N] f32
    value_upper: Any   # [B, N] f32
    leaf: Any          # [B, N] bool: allocated and unexpanded
    count: Any         # [B, N] i64 subtree visit counts
    used: Any          # [B] i64 allocated node count
    states: Any        # state NamedTuple stacked as [B, N, ...]


def _init_tree(env: FunctionalEnv, states0, capacity: int, num_actions: int) -> OPDTree:
    del env
    N, A = capacity, num_actions
    B = states0[0].shape[0]
    device = states0[0].device

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    def arena_of(x):
        arena = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=device)
        arena[:, 0] = x
        return arena

    leaf = full((B, N), False, torch.bool)
    leaf[:, 0] = True
    count = full((B, N), 0, torch.int64)
    count[:, 0] = 1
    return OPDTree(
        parent=full((B, N), -1, torch.int64), action=full((B, N), -1, torch.int64),
        depth=full((B, N), 0, torch.int64), children=full((B, N, A), -1, torch.int64),
        reward=full((B, N), 0.0, torch.float32), done=full((B, N), False, torch.bool),
        value_lower=full((B, N), 0.0, torch.float32), value_upper=full((B, N), 0.0, torch.float32),
        leaf=leaf, count=count, used=full((B,), 1, torch.int64),
        states=type(states0)(*(arena_of(x) for x in states0)))


def _scalars(gamma: float, terminal_reward: float, capacity: int, device):
    """(gamma, terminal_reward, 1 - gamma, gamma ** k for k <= capacity), all
    float32 as the JAX package takes them."""
    g32 = np.float32(gamma)
    return (torch.tensor(g32, device=device),
            torch.tensor(np.float32(terminal_reward), device=device),
            torch.tensor(np.float32(1) - g32, device=device),
            discount_table(gamma, capacity + 1, device))


def _expand(env: FunctionalEnv, params, tree: OPDTree, leaf_idx, base: int, scalars,
            num_actions: int) -> OPDTree:
    """Expand the leaf ``leaf_idx [B]`` of every tree: step the env once per
    action, write the child block at rows ``base .. base + A`` (reference:
    deterministic.py:28-65). In place on the tensors of ``tree``. Ancestor
    count bumps and interior bound backups wait for ``_finalize_bounds``."""
    A = num_actions
    _, terminal_reward, one_minus_gamma, discount = scalars
    B = leaf_idx.shape[0]
    device = leaf_idx.device
    rows = torch.arange(B, device=device)
    block = slice(base, base + A)
    offsets = torch.arange(A, device=device)
    leaf_state = type(tree.states)(*(x[rows, leaf_idx].repeat_interleave(A, dim=0)
                                     for x in tree.states))
    out = env.transition(params, leaf_state, offsets.repeat(B), None,
                         env.null_noise(B * A, device))

    d = tree.depth[rows, leaf_idx] + 1
    reward = out.reward.to(torch.float32).reshape(B, A)
    done = out.terminated.reshape(B, A) | tree.done[rows, leaf_idx][:, None]
    # value_lower + gamma ** (d - 1) * reward is one fused multiply-add in the JAX package
    vl = fma(discount[d - 1][:, None], reward, tree.value_lower[rows, leaf_idx][:, None])
    horizon_term = discount[d][:, None]
    vu = vl + horizon_term / one_minus_gamma
    terminal_value = vl + terminal_reward * horizon_term / one_minus_gamma
    vl = torch.where(done, terminal_value, vl)
    vu = torch.where(done, terminal_value, vu)

    for arena, new in zip(tree.states, out.state):
        arena[:, block] = new.reshape((B, A) + new.shape[1:])
    tree.parent[:, block] = leaf_idx[:, None]
    tree.action[:, block] = offsets
    tree.depth[:, block] = d[:, None]
    tree.children[rows, leaf_idx] = base + offsets
    tree.reward[:, block] = reward
    tree.done[:, block] = done
    tree.value_lower[:, block] = vl
    tree.value_upper[:, block] = vu
    tree.leaf[rows, leaf_idx] = False
    tree.leaf[:, block] = True
    tree.count[:, block] = 1
    tree.used.add_(A)
    return tree


def _greedy_plan(tree, generator, plan_capacity: int, noise=None):
    """Greedy descent by value_lower with random tie-breaking (reference:
    deterministic.py:21-26, abstract.py:143-156); the Gumbel ``noise
    [plan_capacity, B, A]`` breaks the ties, drawn from ``generator`` when
    not given. Serves every tree with ``children`` and ``value_lower``."""
    B, _, A = tree.children.shape
    device = tree.children.device
    rows = torch.arange(B, device=device)
    if noise is None:
        noise = gumbel((plan_capacity, B, A), generator, device)
    node = torch.zeros(B, dtype=torch.int64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for step in range(plan_capacity):
        ch = tree.children[rows, node]
        valid = ch >= 0
        vals = torch.where(valid, tree.value_lower.gather(1, ch.clamp(min=0)), -torch.inf)
        ties = valid & (vals == vals.amax(dim=1, keepdim=True))
        action = (torch.where(ties, 0.0, -torch.inf) + noise[step]).argmax(dim=1)
        live = live & valid.any(dim=1)
        node = torch.where(live, ch.gather(1, action[:, None]).squeeze(1), node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    return actions, (actions >= 0).sum(dim=1)


def _greedy_plan_pcg64(tree, stream, inc, plan_capacity: int):
    """Greedy descent by value_lower with the reference's own draws: ties by
    equality (Node.all_argmax, abstract.py:295-301) broken by
    ``np_random.choice`` (abstract.py:303-311) on a PCG64 stream per tree
    (``utils/pcg64.py``) that reproduces numpy bit for bit. A choice among one
    consumes no draw (numpy's ``rng == 0`` early out), so the draws match the
    reference's get_plan descent (abstract.py:143-156) one to one. Returns
    ``(actions [B, P], lengths [B], stream)``."""
    B, _, A = tree.children.shape
    device = tree.children.device
    rows = torch.arange(B, device=device)
    node = torch.zeros(B, dtype=torch.int64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(plan_capacity):
        ch = tree.children[rows, node]
        valid = ch >= 0
        vals = torch.where(valid, tree.value_lower.gather(1, ch.clamp(min=0)), -torch.inf)
        ties = valid & (vals == vals.amax(dim=1, keepdim=True))
        live = live & valid.any(dim=1)
        stream, idx = pcg64_choice(stream, inc, ties.sum(dim=1), mask=live)
        pos = ties.cumsum(dim=1) - 1
        action = (ties & (pos == idx[:, None])).to(torch.int64).argmax(dim=1)
        node = torch.where(live, ch.gather(1, action[:, None]).squeeze(1), node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    return actions, (actions >= 0).sum(dim=1), stream


def opd_plan_parity(env: FunctionalEnv, params, states0, stream, inc, num_actions: int,
                    expansions: int, gamma: float, terminal_reward: float = 0.0,
                    plan_capacity: int = 32, device="cuda"):
    """``opd_plan`` with the reference's own tie-breaking draws: the same
    expansions (deterministic, the earliest-created optimistic leaf) and the
    plan's ties broken on the PCG64 stream of each tree, bit-exact with the
    reference at a fixed seed. ``stream, inc = pcg64_init(seeds)`` mirrors
    the reference's ``planner.seed(seed)`` (gymnasium np_random ->
    ``Generator(PCG64(seed))``). Returns ``(actions [B, P], lengths [B],
    OPDTree, stream)``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    capacity = 1 + expansions * num_actions
    tree = _init_tree(env, states0, capacity, num_actions)
    scalars = _scalars(gamma, terminal_reward, capacity, device)
    tree = _expansion_rounds(env, params, tree, expansions, scalars, num_actions)
    actions, lengths, stream = _greedy_plan_pcg64(tree, stream, inc, plan_capacity)
    return actions, lengths, tree, stream


def _expansion_rounds(env, params, tree: OPDTree, expansions: int, scalars, num_actions: int,
                      base0: int = 1) -> OPDTree:
    """``expansions`` rounds of [select optimistic leaf -> expand], then one
    bottom-up consolidation. OPD's expansion rule reads only leaf upper bounds
    (reference deterministic.py:106-114), and interior bounds are nested maxes
    whose fixed point does not depend on the order, so the reference's
    per-expansion backup walk (deterministic.py:74-79) is deferred."""
    for i in range(expansions):
        scores = torch.where(tree.leaf, tree.value_upper, -torch.inf)
        # first max == earliest-created leaf, the reference's insertion-ordered max()
        leaf_idx = scores.argmax(dim=1)
        tree = _expand(env, params, tree, leaf_idx, base0 + i * num_actions, scalars, num_actions)
    return _finalize_bounds(tree, max_sweeps=expansions + 1)


def _max_over_children(values, cvalid, cidx):
    B, N, A = cvalid.shape
    return torch.where(cvalid, values.gather(1, cidx).reshape(B, N, A), -torch.inf).amax(dim=2)


def _finalize_bounds(tree: OPDTree, max_sweeps: int) -> OPDTree:
    """Bottom-up fixed point of interior bounds (max over children) and
    subtree counts (1 + sum over children: the closed form of the reference's
    per-expansion +A ancestor bumps). Stops once a sweep changes nothing in
    any tree (about the tree depth); the host reads that once per sweep.
    ``_finalize_bounds.sweeps`` counts the sweeps."""
    B, N, A = tree.children.shape
    cvalid = tree.children >= 0
    cidx = tree.children.clamp(min=0).reshape(B, N * A)
    interior = cvalid.any(dim=2)
    vl, vu, cnt = tree.value_lower, tree.value_upper, tree.count
    for _ in range(max_sweeps):
        child_counts = torch.where(cvalid, cnt.gather(1, cidx).reshape(B, N, A), 0).sum(dim=2)
        nvl = torch.where(interior, _max_over_children(vl, cvalid, cidx), vl)
        nvu = torch.where(interior, _max_over_children(vu, cvalid, cidx), vu)
        ncnt = torch.where(interior, 1 + child_counts, cnt)
        changed = ((nvl != vl) | (nvu != vu) | (ncnt != cnt)).any()
        vl, vu, cnt = nvl, nvu, ncnt
        _finalize_bounds.sweeps += 1
        if not bool(changed):
            break
    return tree._replace(value_lower=vl, value_upper=vu, count=cnt)


_finalize_bounds.sweeps = 0


def opd_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
             num_actions: int, expansions: int, gamma: float, terminal_reward: float = 0.0,
             plan_capacity: int = 32, noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim): ``expansions`` rounds of [select optimistic leaf -> expand],
    the consolidation, and the greedy plan (reference:
    deterministic.py:106-122). Returns ``(actions [B, P] with -1 past the
    plan, lengths [B], OPDTree)``.

    ``noise`` is Gumbel noise ``[plan_capacity, B, A]`` that breaks the ties of
    the plan's descent; without it, it is drawn from ``generator``.
    """
    device = resolve_device(device)
    if noise is None and generator is None:
        raise ValueError("opd_plan needs a generator or noise")
    params = params_to(params, device)
    states0 = params_to(states0, device)
    capacity = 1 + expansions * num_actions
    tree = _init_tree(env, states0, capacity, num_actions)
    scalars = _scalars(gamma, terminal_reward, capacity, device)
    tree = _expansion_rounds(env, params, tree, expansions, scalars, num_actions)
    actions, lengths = _greedy_plan(tree, generator, plan_capacity,
                                    None if noise is None else noise_tensor(noise, device))
    return actions, lengths, tree


def opd_plan_continue(env: FunctionalEnv, params, tree: OPDTree, states0,
                      generator: torch.Generator | None, num_actions: int, expansions: int,
                      gamma: float, terminal_reward: float = 0.0, plan_capacity: int = 32,
                      noise=None, device="cuda"):
    """Continue planning in carried (re-rooted) arenas: ``expansions`` more
    rounds, the reference's ``plan`` on a stepped tree
    (deterministic.py:116-122 after step_by_subtree). The last
    ``expansions * num_actions`` slots of each arena must be unallocated
    padding (``opd_grow_arena`` provides them); the new children go there at
    round-indexed bases. The root state is refreshed from the current env
    (deterministic.py:117). The argument's tensors are not written."""
    device = resolve_device(device)
    if noise is None and generator is None:
        raise ValueError("opd_plan_continue needs a generator or noise")
    params = params_to(params, device)
    states0 = params_to(states0, device)
    tree = OPDTree(*(t.to(device).clone() for t in tree[:-1]),
                   states=type(tree.states)(*(x.to(device).clone() for x in tree.states)))
    capacity = tree.parent.shape[1]
    for arena, x in zip(tree.states, states0):
        arena[:, 0] = x
    scalars = _scalars(gamma, terminal_reward, capacity, device)
    tree = _expansion_rounds(env, params, tree, expansions, scalars, num_actions,
                             base0=capacity - expansions * num_actions)
    actions, lengths = _greedy_plan(tree, generator, plan_capacity,
                                    None if noise is None else noise_tensor(noise, device))
    return actions, lengths, tree


def opd_step_subtree(tree: OPDTree, action, gamma: float, num_actions: int, out_capacity: int,
                     backup_sweeps: int = 64):
    """Re-root each arena at the root's child for ``action`` (an int or
    ``[B]``; reference: abstract.py:194-206 step_by_subtree +
    deterministic.py:124-132).

    The reference moves a root pointer and rescales every leaf's bounds by
    (v - r0) / gamma, then re-backs-up. Here the subtree is compacted into a
    fresh arena with a stable gather (``arena_subtree_gather``). Truncation
    has no reference analog (its trees grow without bound); nodes re-leafed by
    truncation get their optimistic leaf bound restored, and bottom-up sweeps
    recompute the interior bounds.

    Returns ``(new_tree, valid [B])``; ``valid`` is False where the action was
    never explored and the caller must plan from scratch (abstract.py:203-206).
    """
    del num_actions  # the arena's own width decides
    B, N, A = tree.children.shape
    device = tree.children.device
    rows = torch.arange(B, device=device)
    action = torch.as_tensor(action, dtype=torch.int64, device=device).expand(B)
    gamma_t, _, one_minus_gamma, discount = _scalars(gamma, 0.0, N, device)
    new_root = tree.children[:, 0].gather(1, action[:, None]).squeeze(1)
    old_of_new, new_id, used, slot, valid = arena_subtree_gather(
        tree.parent, tree.children, tree.used, action, out_capacity)

    def take(x, fill):
        picked = x[rows[:, None], old_of_new]
        return torch.where(slot.reshape(slot.shape + (1,) * (picked.dim() - 2)), picked, fill)

    parent = take(new_id.gather(1, tree.parent.clamp(min=0)), -1)
    parent[:, 0] = -1  # the new root
    renamed = new_id.gather(1, tree.children.clamp(min=0).reshape(B, N * A)).reshape(B, N, A)
    children = take(torch.where(tree.children >= 0, renamed, -1), -1)
    depth = take(tree.depth - 1, 0)
    reward = take(tree.reward, 0.0)
    done = take(tree.done, False)
    count = take(tree.count, 0)
    act = take(tree.action, -1)

    # bound rescale (deterministic.py:129-131): v' = (v - r0) / gamma
    r0 = tree.reward[rows, new_root.clamp(min=0)][:, None]
    vl = take((tree.value_lower - r0) / gamma_t, 0.0)
    vu = take((tree.value_upper - r0) / gamma_t, 0.0)

    was_leaf = take(tree.leaf, False)
    is_leaf = (children < 0).all(dim=2) & slot
    # nodes re-leafed by truncation: restore the optimistic leaf bound
    optimistic = vl + discount[depth.clamp(min=0)] / one_minus_gamma * (~done).to(torch.float32)
    vu = torch.where(is_leaf & ~was_leaf, torch.where(done, vl, optimistic), vu)

    # bottom-up interior recompute: max-over-children sweeps until a sweep
    # changes nothing (about the carried depth), at most ``backup_sweeps``
    M = out_capacity
    cvalid = children >= 0
    cidx = children.clamp(min=0).reshape(B, M * A)
    interior = ~is_leaf & slot
    for _ in range(backup_sweeps):
        nvl = torch.where(interior, _max_over_children(vl, cvalid, cidx), vl)
        nvu = torch.where(interior, _max_over_children(vu, cvalid, cidx), vu)
        changed = ((nvl != vl) | (nvu != vu)).any()
        vl, vu = nvl, nvu
        if not bool(changed):
            break

    states = type(tree.states)(*(x[rows[:, None], old_of_new] for x in tree.states))
    new_tree = OPDTree(parent=parent, action=act, depth=depth, children=children, reward=reward,
                       done=done, value_lower=vl, value_upper=vu, leaf=is_leaf, count=count,
                       used=used, states=states)
    return new_tree, valid


def opd_grow_arena(tree: OPDTree, extra: int) -> OPDTree:
    """Pad every arena with ``extra`` unallocated slots so that a carried tree
    can absorb the next plan's expansions."""
    def pad(x, fill):
        return torch.cat([x, torch.full((x.shape[0], extra) + x.shape[2:], fill, dtype=x.dtype,
                                        device=x.device)], dim=1)

    return OPDTree(
        parent=pad(tree.parent, -1), action=pad(tree.action, -1), depth=pad(tree.depth, 0),
        children=pad(tree.children, -1), reward=pad(tree.reward, 0), done=pad(tree.done, False),
        value_lower=pad(tree.value_lower, 0), value_upper=pad(tree.value_upper, 0),
        leaf=pad(tree.leaf, False), count=pad(tree.count, 0), used=tree.used,
        states=type(tree.states)(*(pad(x, 0) for x in tree.states)))


def opd_plan_batch(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                   num_actions: int, expansions: int, gamma: float, terminal_reward: float = 0.0,
                   plan_capacity: int = 32, noise=None, device="cuda"):
    """Batched OPD over the leading tree axis: ``opd_plan``, which is
    batch-first already, under the noise layout of the JAX package's fused
    batch planner, ``[plan_capacity, A, B]``."""
    if noise is not None:
        noise = noise_tensor(noise, resolve_device(device)).transpose(1, 2)
    return opd_plan(env, params, states0, generator, num_actions=num_actions,
                    expansions=expansions, gamma=gamma, terminal_reward=terminal_reward,
                    plan_capacity=plan_capacity, noise=noise, device=device)


def opd_plan_batch_vmap(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                        num_actions: int, expansions: int, gamma: float,
                        terminal_reward: float = 0.0, plan_capacity: int = 32, noise=None,
                        device="cuda"):
    """The JAX package vmaps its single-tree ``opd_plan`` here, as the
    semantics oracle of its fused batch planner; this package's ``opd_plan``
    is batch-first already, with noise ``[plan_capacity, B, A]``."""
    return opd_plan(env, params, states0, generator, num_actions=num_actions,
                    expansions=expansions, gamma=gamma, terminal_reward=terminal_reward,
                    plan_capacity=plan_capacity, noise=noise, device=device)


class DeterministicPlannerAgent(AbstractTreeSearchAgent):
    """OPD agent (reference: deterministic.py:135-139), planning one tree
    (B = 1). Supports ``step_strategy: subtree``: the node arena is re-rooted
    with ``opd_step_subtree`` between env steps and the next plan continues in
    the carried tree (reference: deterministic.py:124-132)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({"budget": 100, "subtree_carry": None})
        return config

    def make_planner(self):
        self.carried_tree = None  # arena carried across steps (subtree strategy)

    def _sizes(self, num_actions):
        expansions = max(int(self.config["budget"]) // num_actions, 1)
        carry = self.config.get("subtree_carry") or expansions * num_actions
        return expansions, int(carry)

    def planner_plan(self, env, observation):
        functional = env.functional
        num_actions = functional.action_space.n
        expansions, _ = self._sizes(num_actions)
        kwargs = dict(num_actions=num_actions, expansions=expansions,
                      gamma=float(self.config["gamma"]),
                      terminal_reward=float(self.config["terminal_reward"]),
                      plan_capacity=min(max(expansions, 1), 64), device=self.device)
        if self.carried_tree is not None:
            actions, lengths, tree = opd_plan_continue(
                functional, env.params, self.carried_tree, env.state, self.generator, **kwargs)
        else:
            actions, lengths, tree = opd_plan(
                functional, env.params, env.state, self.generator, **kwargs)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])

    def planner_step_tree(self, actions):
        if self.config["step_strategy"] != "subtree":
            return
        tree = self.last_plan_data
        if tree is None or not actions:
            self.carried_tree = None
            return
        num_actions = tree.children.shape[2]
        expansions, carry = self._sizes(num_actions)
        new_tree, valid = opd_step_subtree(
            tree, int(actions[0]), float(self.config["gamma"]), num_actions=num_actions,
            out_capacity=carry)
        if bool(valid[0]):
            self.carried_tree = opd_grow_arena(new_tree, expansions * num_actions)
        else:  # never-explored action: plan from scratch (abstract.py:203-206)
            self.carried_tree = None

    def reset(self):
        super().reset()
        self.carried_tree = None
