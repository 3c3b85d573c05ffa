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
  node are consecutive slots).

The JAX package lays its arena out node-major ``[N, B]`` and reaches rows
through one-hot masks, for the TPU; here the arena is ``[B, N]`` like every
other arena of this package and rows are indexed directly. Agreement with
``mcts_plan`` is statistical, not bitwise.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rl_agents_torch.agents.tree_search.mcts import (
    MCTSTree,
    _where_state,
    discount_table,
    gumbel,
    noise_tensor,
    step_noise,
)
from rl_agents_torch.envs.base import params_to
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
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, H, E = num_actions, horizon, episodes
    B = states0[0].shape[0]
    N = 1 + E * A
    i64, f32 = torch.int64, torch.float32
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    discount = discount_table(gamma, H, device)
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

    arena = _Arena(first_child=torch.full((B, N), -1, dtype=i64, device=device),
                   count=torch.zeros((B, N), dtype=f32, device=device),
                   value=torch.zeros((B, N), dtype=f32, device=device),
                   expansions=torch.zeros((B,), dtype=i64, device=device))
    first_child, count, value, expansions = arena

    for episode in range(E):
        base = 1 + episode * A  # this episode's expansion slots
        g = noise[episode] if noise is not None else gumbel((H, 2, A, B), generator, device)
        state = states0
        node = torch.zeros(B, dtype=i64, device=device)
        in_tree = torch.ones(B, dtype=torch.bool, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        total = torch.zeros(B, dtype=f32, device=device)
        visited = torch.zeros((B, H + 1), dtype=i64, device=device)
        weights = torch.zeros((B, H + 1), dtype=f32, device=device)
        weights[:, 0] = 1.0  # root always on path
        for h in range(H):
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
            tie_logits = torch.where(scores == scores.amax(dim=1, keepdim=True), 0.0, -torch.inf)
            act_uct = (tie_logits + g[h, 0].t()).argmax(dim=1)
            act_roll = (rollout_logits + g[h, 1].t()).argmax(dim=1)
            descending = in_tree & has_children
            action = torch.where(descending, act_uct, act_roll)

            # -- env step (masked once terminal)
            live = ~terminal
            out = env.transition(params, state, action, generator,
                                 step_noise(env_noise, episode, h))
            total = total + torch.where(live, discount[h] * out.reward.to(f32), 0.0)
            state = _where_state(live, out.state, state)
            terminal = terminal | (live & out.terminated)

            # -- tree position + path record
            node = torch.where(descending, fc + action, node)
            visited[:, h + 1] = node
            weights[:, h + 1] = descending
            in_tree = descending & ~terminal

        # -- backup: one pass over the recorded path (reference mcts.py:248-265).
        # Path nodes are distinct within a tree (weights mask the rest), so the
        # per-node running-mean updates commute: each node receives one
        # non-zero term and zeros.
        count.scatter_add_(1, visited, weights)
        cnt_new = count.gather(1, visited)
        val_old = value.gather(1, visited)
        delta = weights * (total[:, None] - val_old) / torch.clamp(cnt_new, min=1.0)
        value.scatter_add_(1, visited, delta)

    # -- plan extraction (reference mcts.py:212-218): max count, ties by value
    node = torch.zeros(B, dtype=i64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(H):
        fc = first_child[rows, node]
        valid = fc >= 0
        kids = torch.where(valid, fc, 0)[:, None] + offsets
        counts = torch.where(valid[:, None], count.gather(1, kids), -1.0)
        vals = torch.where(counts == counts.amax(dim=1, keepdim=True), value.gather(1, kids),
                           -torch.inf)
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
    prior = torch.cat([torch.ones(1, dtype=f32, device=device), prior_probs.repeat(E)]).expand(B, N)
    tree = MCTSTree(parent=parent, children=children, count=count.to(i64), value=value,
                    prior=prior.contiguous(), used=1 + A * expansions)
    return actions, lengths, tree
