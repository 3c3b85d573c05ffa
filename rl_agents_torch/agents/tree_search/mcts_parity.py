"""Reference-exact MCTS: bit-identical planning at a fixed seed, batch-first.

Port of ``rl_agents_tpu/agents/tree_search/mcts_parity.py``. It replays the
reference's episode loop draw for draw on a PCG64 stream per tree
(``utils/pcg64.py``, numpy-bit-exact):

- descent ties: ``random_argmax`` = ``all_argmax`` float-equality ties broken
  by ``np_random.choice(indices)``, a buffered-Lemire bounded integer that
  draws nothing when the argmax is unique (reference: mcts.py:220-233,
  abstract.py:295-311);
- rollout actions: ``np_random.choice(actions, 1, p=probs)``, a cdf search
  over one ``Generator.random()`` double per rollout step (reference:
  mcts.py:160-177);
- expansion and backup draw nothing (reference: mcts.py:237-265).

All node statistics are float64 in the reference's operation order, each
product rounded on its own (``utils/exact.py``), so the float comparisons
(tie sets, argmaxes) resolve identically. The descent and the backup are
masked steps over the B trees; the env is stepped with its ``null_noise``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.mcts import _where_state
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.exact import mul_add_exact
from rl_agents_torch.utils.pcg64 import pcg64_choice, pcg64_double


class ParityArena(NamedTuple):
    children: torch.Tensor  # [B, N, A] i64, -1 = absent
    parent: torch.Tensor    # [B, N] i64
    prior: torch.Tensor     # [B, N] f64
    value: torch.Tensor     # [B, N] f64
    count: torch.Tensor     # [B, N] i64
    used: torch.Tensor      # [B] i64


def tie_choice(stream, inc, ties, mask):
    """``np_random.choice`` among the ``True`` entries of ``ties [B, A]`` where
    ``mask``: the index of the drawn tie. Returns ``(stream, index [B])``."""
    stream, idx = pcg64_choice(stream, inc, ties.sum(dim=1), mask=mask)
    pos = ties.cumsum(dim=1) - 1
    return stream, (ties & (pos == idx[:, None])).to(torch.int64).argmax(dim=1)


def selection_plan(children, count, value, plan_capacity: int):
    """The reference's selection rule, no draw (reference: mcts.py:212-218,
    abstract.py:143-156): the most visited child, the first of the best
    valued among equals. Returns ``(actions [B, P], lengths [B])``."""
    B = children.shape[0]
    device = children.device
    rows = torch.arange(B, device=device)
    node = torch.zeros(B, dtype=torch.int64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(plan_capacity):
        ch = children[rows, node]
        chs = ch.clamp(min=0)
        counts = count.gather(1, chs)
        ties = counts == counts.amax(dim=1, keepdim=True)
        action = torch.where(ties, value.gather(1, chs), -torch.inf).argmax(dim=1)
        live = live & (ch[:, 0] >= 0)
        node = torch.where(live, ch.gather(1, action[:, None]).squeeze(1), node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    return actions, (actions >= 0).sum(dim=1)


def mcts_plan_parity(env: FunctionalEnv, params, states0, stream, inc, num_actions: int,
                     episodes: int, horizon: int, gamma: float, temperature: float,
                     plan_capacity: int = 16, device="cuda"):
    """Plan B trees exactly as the reference MCTS at fixed seeds.
    ``stream, inc = pcg64_init(seeds)`` mirrors ``planner.seed(seed)``.
    Returns ``(actions [B, P], lengths [B], ParityArena, stream, totals
    [B, episodes])``, ``totals`` being each episode's return (the argument of
    each ``update_branch`` call)."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, H = num_actions, horizon
    B = states0[0].shape[0]
    f64 = torch.float64
    N = 1 + episodes * A + A  # + A scratch slots for the masked non-expansions
    # host constants with the reference's Python float arithmetic
    gamma_pows = torch.tensor([gamma ** d for d in range(H)], dtype=f64, device=device)
    cdf = np.ones(A) / A
    cdf = cdf.cumsum()
    cdf /= cdf[-1]
    rollout_cdf = torch.tensor(cdf, dtype=f64, device=device)
    ta = temperature * A  # temperature * len(parent.children)
    null = env.null_noise(B, device)
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)

    children = torch.full((B, N, A), -1, dtype=torch.int64, device=device)
    parent = torch.full((B, N), -1, dtype=torch.int64, device=device)
    prior = torch.ones((B, N), dtype=f64, device=device)
    value = torch.zeros((B, N), dtype=f64, device=device)
    count = torch.zeros((B, N), dtype=torch.int64, device=device)
    used = torch.ones(B, dtype=torch.int64, device=device)
    totals = []

    for _ in range(episodes):
        # ---- descent (reference: mcts.py:143-149)
        node = torch.zeros(B, dtype=torch.int64, device=device)
        depth = torch.zeros(B, dtype=torch.int64, device=device)
        total = torch.zeros(B, dtype=f64, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        state = states0
        for _ in range(H):
            ch = children[rows, node]
            active = (depth < H) & (ch[:, 0] >= 0) & ~terminal
            chs = ch.clamp(min=0)
            sv = value.gather(1, chs) + (ta * prior.gather(1, chs)) / (
                count.gather(1, chs) + 1).to(f64)
            ties = sv == sv.amax(dim=1, keepdim=True)
            stream, action = tie_choice(stream, inc, ties, active)
            out = env.transition(params, state, action, None, null)
            new_total = mul_add_exact(total, gamma_pows[depth.clamp(max=H - 1)],
                                      out.reward.to(f64))
            node = torch.where(active, ch.gather(1, action[:, None]).squeeze(1), node)
            total = torch.where(active, new_total, total)
            terminal = torch.where(active, out.terminated, terminal)
            state = _where_state(active, out.state, state)
            depth = depth + active

        # ---- expansion (reference: mcts.py:151-154, 237-246); trees that do
        # not expand write the scratch slots
        do_expand = (children[rows, node, 0] < 0) & (depth < H) & (~terminal | (node == 0))
        base = torch.where(do_expand, used, N - A)
        slots = base[:, None] + offsets
        children[rows, node] = torch.where(do_expand[:, None], slots, children[rows, node])
        parent.scatter_(1, slots, node[:, None].expand(B, A))
        prior.scatter_(1, slots, torch.full((B, A), 1.0 / A, dtype=f64, device=device))
        value.scatter_(1, slots, torch.zeros((B, A), dtype=f64, device=device))
        count.scatter_(1, slots, torch.zeros((B, A), dtype=torch.int64, device=device))
        used = used + torch.where(do_expand, A, 0)

        # ---- rollout (reference: mcts.py:160-177)
        stopped = terminal
        for h in range(H):
            active = (h >= depth) & ~stopped
            stream, u = pcg64_double(stream, inc, mask=active)
            action = (rollout_cdf <= u[:, None]).sum(dim=1)
            out = env.transition(params, state, action, None, null)
            total = torch.where(active, mul_add_exact(total, gamma_pows[h], out.reward.to(f64)),
                                total)
            state = _where_state(active, out.state, state)
            stopped = stopped | (active & (out.terminated | out.truncated))

        # ---- backup (reference: mcts.py:248-265)
        n = node
        for _ in range(H + 1):
            on_path = n >= 0
            at = n.clamp(min=0)
            cnt = count[rows, at] + 1
            old = value[rows, at]
            val = mul_add_exact(old, 1.0 / cnt.to(f64), total - old)
            count[rows, at] = torch.where(on_path, cnt, count[rows, at])
            value[rows, at] = torch.where(on_path, val, old)
            n = torch.where(on_path, parent[rows, at], n)
        totals.append(total)

    arena = ParityArena(children=children, parent=parent, prior=prior, value=value, count=count,
                        used=used)
    actions, lengths = selection_plan(children, count, value, plan_capacity)
    return actions, lengths, arena, stream, torch.stack(totals, dim=1)
