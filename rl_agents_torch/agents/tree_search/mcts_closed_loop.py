"""Closed-loop MCTS: chance nodes keyed by observed outcomes, batch-first.

Port of ``rl_agents_tpu/agents/tree_search/mcts_closed_loop.py`` (reference:
the MCTS ``closed_loop`` option, mcts.py:147,267-273): each action edge holds
children keyed by the observed next state (``ops/hashing.py::obs_key``, at
most ``width`` of them), so value estimates condition on outcomes instead of
open-loop action sequences. It runs on the decision/chance arenas of
``mcts_dpw.py`` with the plain MCTS selection score
``value + T * |children| * prior / (count + 1)`` and full action expansion
with priors, ``Nd = 2 + episodes * horizon`` decision and ``1 + Nd * A``
chance slots per tree.

The draws are ``mcts_dpw.DPWNoise`` without ``expand``.
"""
from __future__ import annotations

import torch

from rl_agents_torch.agents.tree_search.mcts import (
    _masked_random_argmax,
    _where_state,
    discount_table,
)
from rl_agents_torch.agents.tree_search.mcts_dpw import (
    DPWNoise,
    _put,
    backup,
    chance_child,
    episode_noise,
    init_dpw_tree,
    rollout,
    root_action,
)
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma


def mcts_closed_loop_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
                          prior_probs, rollout_probs, num_actions: int, episodes: int,
                          horizon: int, gamma: float, temperature: float, width: int = 8,
                          noise: DPWNoise | None = None, device="cuda"):
    """Plan B trees at once from ``states0``. Returns ``(action [B],
    DPWTree)``: the first action only, the plan conditions on the
    observations after it. ``noise`` (``DPWNoise`` with ``expand=None``,
    leading axis ``episodes``) holds every draw; without it they come from
    ``generator``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, W, H, E = num_actions, width, horizon, episodes
    B = states0[0].shape[0]
    f32 = torch.float32
    Nd = 2 + E * H
    Nc = 1 + Nd * A
    tree = init_dpw_tree(B, Nd, Nc, A, W, device)
    c_prior = torch.ones((B, Nc), dtype=f32, device=device)
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    discount = discount_table(gamma, 2 * H, device)
    temperature = torch.tensor(temperature, dtype=f32, device=device)
    prior_probs = torch.as_tensor(prior_probs, dtype=f32).to(device)
    rollout_logits = torch.log(torch.as_tensor(rollout_probs, dtype=f32).to(device))

    for episode in range(E):
        draws = episode_noise(noise, episode, generator, B, H, A, W, device, expand=False)
        node = torch.zeros(B, dtype=torch.int64, device=device)
        depth = torch.zeros(B, dtype=torch.int64, device=device)
        total = torch.zeros(B, dtype=f32, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        state = states0
        for step in range(H):
            ch = tree.d_children[rows, node]
            active = (ch[:, 0] >= 0) & (depth < H) & ~terminal
            valid = ch >= 0
            chs = ch.clamp(min=0)
            n_children = valid.sum(dim=1, keepdim=True).to(f32)
            cvals = torch.where(valid, tree.c_value.gather(1, chs), 0.0)
            cprior = torch.where(valid, c_prior.gather(1, chs), 0.0)
            ccnt = torch.where(valid, tree.c_count.gather(1, chs), 0)
            scores = cvals + temperature * n_children * cprior / (ccnt.to(f32) + 1.0)
            action = _masked_random_argmax(draws.select[step], scores, valid)
            env_noise = None if draws.env is None else draws.env[step]
            out = env.step(params, state, action, generator, env_noise)
            chance = ch.gather(1, action[:, None]).squeeze(1).clamp(min=0)
            # obs-keyed chance child (reference: mcts.py:267-273), capped at W
            can_widen = tree.c_n_children[rows, chance] < W
            child = chance_child(tree, rows, chance, obs_key(out.obs), can_widen,
                                 draws.slot[step], active)
            # total + gamma ** depth * reward is one fused multiply-add in the JAX package
            new_total = fma(discount[depth], out.reward.to(f32), total)
            node = torch.where(active, child, node)
            state = _where_state(active, out.state, state)
            total = torch.where(active, new_total, total)
            terminal = terminal | (active & out.terminated)
            depth = depth + active

        # ---- expand every action at once, with priors (reference: mcts.py:237-246)
        do_expand = (depth < H) & (~terminal | (node == 0)) \
            & (tree.d_children[rows, node, 0] < 0)
        base = tree.c_used.clone()
        ids = base[:, None] + offsets
        _put(tree.d_children, (rows, node), do_expand[:, None], ids)
        _put(tree.d_n_children, (rows, node), do_expand, torch.full_like(node, A))
        slots = ids.clamp(max=Nc - 1)
        block = do_expand[:, None]
        tree.c_parent.scatter_(1, slots, torch.where(block, node[:, None].expand(B, A),
                                                     tree.c_parent.gather(1, slots)))
        tree.c_action.scatter_(1, slots, torch.where(block, offsets.expand(B, A),
                                                     tree.c_action.gather(1, slots)))
        c_prior.scatter_(1, slots, torch.where(block, prior_probs.expand(B, A),
                                               c_prior.gather(1, slots)))
        tree.c_used.add_(torch.where(do_expand, A, 0))

        total = rollout(env, params, state, depth, total, terminal, draws, rollout_logits,
                        discount, H, generator)
        backup(tree, rows, node, total, H)
    return root_action(tree), tree
