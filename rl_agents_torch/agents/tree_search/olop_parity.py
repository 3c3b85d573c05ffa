"""Reference-exact OLOP/KL-OLOP: bit-identical planning at a fixed seed,
batch-first.

Port of ``rl_agents_tpu/agents/tree_search/olop_parity.py``. The reference's
draws per episode (reference: olop.py:63-92):

1. ``state.seed(np_random.randint(2**30))``: one bounded integer per episode
   (it seeds the env fork, a no-op for deterministic envs, but the draw
   advances the stream);
2. with ``continuation_type: "uniform"``: one ``choice(A)`` per leaf
   expansion (olop.py:80-82); with ``"zeros"`` (the default) the
   continuation is action 0 and draws nothing;
3. the descent (first max of the upper bounds, olop.py:84-85), the node
   updates with the float64 KL-UCB solve (``utils/exact.py``) and the
   B-value backup ``mu_ucb + gamma * max(children)`` (olop.py:182-193) draw
   nothing.

Each of B trees has its own stream; the backup is masked steps. The env is
stepped with its ``null_noise``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.mcts_parity import selection_plan
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.exact import exact_mul, kl_upper_bound_exact
from rl_agents_torch.utils.pcg64 import pcg64_choice, pcg64_integers, stream_where


class OLOPParityArena(NamedTuple):
    children: torch.Tensor  # [B, N, A] i64, -1 = absent
    parent: torch.Tensor    # [B, N] i64
    depth: torch.Tensor     # [B, N] i64
    cum: torch.Tensor       # [B, N] f64 cumulative reward
    count: torch.Tensor     # [B, N] i64
    mu: torch.Tensor        # [B, N] f64 KL-UCB of the mean reward
    vu: torch.Tensor        # [B, N] f64 sequence B-value
    done: torch.Tensor      # [B, N] bool
    used: torch.Tensor      # [B] i64


def olop_plan_parity(env: FunctionalEnv, params, states0, stream, inc, num_actions: int,
                     episodes: int, horizon: int, gamma: float,
                     continuation_uniform: bool = False, plan_capacity: int = 16,
                     device="cuda"):
    """Plan B trees exactly as the reference KL-OLOP at fixed seeds.
    ``stream, inc = pcg64_init(seeds)`` mirrors ``planner.seed(seed)``.
    Returns ``(actions [B, P], lengths [B], OLOPParityArena, stream)``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, H = num_actions, horizon
    B = states0[0].shape[0]
    f64 = torch.float64
    N = 1 + episodes * H * A + A  # one expansion per step at most, + scratch
    # host constants with the reference's Python float arithmetic
    threshold = float(4 * np.log(episodes))  # eval("4*np.log(time)")
    vu_init = torch.tensor([(1 - gamma ** (H + 1 - d)) / (1 - gamma) for d in range(H + 1)],
                           dtype=f64, device=device)
    null = env.null_noise(B, device)
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    children = full((B, N, A), -1, torch.int64)
    parent = full((B, N), -1, torch.int64)
    depth = full((B, N), 0, torch.int64)
    cum = full((B, N), 0.0, f64)
    count = full((B, N), 0, torch.int64)
    mu = full((B, N), 1.0, f64)  # the KL type starts mu_ucb at 1 (reference: olop.py:117)
    vu = vu_init[0].expand(B, N).clone()
    done = full((B, N), False, torch.bool)
    used = full((B,), 1, torch.int64)

    def put(arena, slots, values):
        arena.scatter_(1, slots, values.expand(slots.shape).to(arena.dtype))

    for _ in range(episodes):
        # the reference seeds each env fork from the planner's stream (olop.py:73)
        stream, _ = pcg64_integers(stream, inc, 2 ** 30)
        node = torch.zeros(B, dtype=torch.int64, device=device)
        state = states0
        for _ in range(H):
            # ---- expansion at leaves (reference: olop.py:78-82, 168-178)
            do_expand = children[rows, node, 0] < 0
            base = torch.where(do_expand, used, N - A)
            slots = base[:, None] + offsets
            d_child = depth[rows, node] + 1
            children[rows, node] = torch.where(do_expand[:, None], slots, children[rows, node])
            put(parent, slots, node[:, None])
            put(depth, slots, d_child[:, None])
            put(cum, slots, torch.zeros(1, dtype=f64, device=device))
            put(count, slots, torch.zeros(1, dtype=torch.int64, device=device))
            put(mu, slots, torch.ones(1, dtype=f64, device=device))
            put(vu, slots, vu_init[d_child][:, None])
            put(done, slots, torch.zeros(1, dtype=torch.bool, device=device))
            used = used + torch.where(do_expand, A, 0)
            ch = children[rows, node]

            # ---- action selection
            if continuation_uniform:
                new, draw = pcg64_choice(stream, inc, torch.where(do_expand, A, 1))
                stream = stream_where(do_expand, new, stream)
                leaf_action = draw
            else:
                leaf_action = torch.zeros(B, dtype=torch.int64, device=device)
            ucb_action = vu.gather(1, ch).argmax(dim=1)  # the first max
            action = torch.where(do_expand, leaf_action, ucb_action)

            # ---- transition and node update (reference: olop.py:87-90, 135-163)
            out = env.transition(params, state, action, None, null)
            node = ch.gather(1, action[:, None]).squeeze(1)
            done_new = done[rows, node] | out.terminated
            r_eff = torch.where(done_new, 0.0, out.reward.to(f64))
            cum2 = cum[rows, node] + r_eff
            count2 = count[rows, node] + 1
            cum[rows, node] = cum2
            count[rows, node] = count2
            mu[rows, node] = kl_upper_bound_exact(cum2, count2, threshold)
            done[rows, node] = done_new
            state = out.state

        # ---- backup to the root (reference: olop.py:180-193); the final
        # node is a depth-H leaf, its value_upper is mu_ucb
        vu[rows, node] = mu[rows, node]
        n = node
        for _ in range(H):
            p = parent[rows, n]
            up = p >= 0
            at = p.clamp(min=0)
            best = vu.gather(1, children[rows, at].clamp(min=0)).amax(dim=1)
            val = mu[rows, at] + exact_mul(gamma, best)
            vu[rows, at] = torch.where(up, val, vu[rows, at])
            n = torch.where(up, at, n)

    arena = OLOPParityArena(children=children, parent=parent, depth=depth, cum=cum, count=count,
                            mu=mu, vu=vu, done=done, used=used)
    actions, lengths = selection_plan(children, count, vu, plan_capacity)
    return actions, lengths, arena, stream
