"""Budgeted greedy policy: Pareto frontiers and optimal mixtures, batch-first.

Port of ``rl_agents_tpu/agents/budgeted_ftq/greedy_policy.py`` (reference:
budgeted_ftq/greedy_policy.py:16-123). Every function takes S states at once
on a leading axis. The frontier of a state's (Qc, Qr) cloud of P points is
the dense hull membership of the JAX package: a point is on the strict upper
hull when no valid pair of points covers it, an O(P^3) comparison. Eager
torch materializes the ``[S, P, P, P]`` comparison, so it runs over chunks
of states (and of points, when one state's comparison is larger), none of
whose intermediates exceeds ``HULL_BUDGET`` elements, the vertical-run step
included.

Frontier semantics (greedy_policy.py:55-102): the points dominated by the
max-Qr point are dropped, and the frontier is the top face of the convex
hull from the min-Qc end to the max-Qr point; collinear interior points and
all but the best point of a vertical run are dropped. A mixture
interpolates the two frontier points that bracket the budget
(greedy_policy.py:16-36), saturating when the budget is below the cheapest
point or above the last.

Membership is decided by the sign of the cross product ``(qc_b - qc_a) *
(qr_i - qr_a) - (qr_b - qr_a) * (qc_i - qc_a)``, each product rounded to
float32, as the JAX package's dense form computes it op by op (and its chain
decides it). Compiled, the JAX dense form fuses the cross product into one
multiply-add, which leaves the rounding error of the product at a point's
own pair (b = i) and covers the point about half the time, so a random
cloud collapses towards its cheapest point (ROADMAP.md §3). The port does
not reproduce that.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

HULL_BUDGET = 1 << 25  # elements of the largest [states, P, P, points] intermediate


class Frontier(NamedTuple):
    """Top frontier points sorted by qc ascending, padded with the last one."""

    qc: Any       # [S, P]
    qr: Any       # [S, P]
    action: Any   # [S, P] int
    budget: Any   # [S, P] beta generating the point
    valid: Any    # [S, P] bool
    count: Any    # [S] int


class Mixture(NamedTuple):
    action_inf: Any
    action_sup: Any
    budget_inf: Any
    budget_sup: Any
    qr_inf: Any
    qr_sup: Any
    qc_inf: Any
    qc_sup: Any
    probability_sup: Any


def lexsort_order(primary, secondary):
    """``jnp.lexsort((secondary, primary))`` along the last axis: ascending
    by ``primary``, ties by ``secondary``, then by index (two stable sorts)."""
    first = torch.argsort(secondary, dim=-1, stable=True)
    second = torch.argsort(primary.gather(-1, first), dim=-1, stable=True)
    return first.gather(-1, second)


def _sorted_cloud(qr, qc):
    """Drop the points dominated by the max-qr point (the first max on
    ties) and sort by (qc, qr), the dropped points last. Returns ``(order,
    qc_s, qr_s, valid_s)``."""
    max_idx = qr.argmax(dim=-1, keepdim=True)
    keep = qc <= qc.gather(-1, max_idx)
    order = lexsort_order(torch.where(keep, qc, torch.inf), qr)
    return order, qc.gather(-1, order), qr.gather(-1, order), keep.gather(-1, order)


def cross_product(o_qc, o_qr, a_qc, a_qr, b_qc, b_qr):
    """``(a - o) x (b - o)`` in (qc, qr), each product rounded to float32
    (separate kernels on the card too, so nothing fuses them)."""
    return (a_qc - o_qc) * (b_qr - o_qr) - (a_qr - o_qr) * (b_qc - o_qc)


def _off_hull(qc_s, qr_s, valid_s, budget: int):
    """``off[s, i]``: some valid pair (a, b) spans point i with i strictly
    below the chord, or on it strictly between the endpoints; or i is not
    the best point of its vertical run (equal qc: only the best-qr point,
    the last in sort order, stays). Computed over blocks of states and of
    points i, so that no ``[states, P, P, points]`` or ``[states, P, P]``
    intermediate holds more than ``budget`` elements (for P * P <=
    ``budget``)."""
    S, P = qc_s.shape
    block = min(P, max(1, budget // (P * P)))
    chunk = max(1, budget // (P * P * block))
    _off_hull.blocks = -(-S // chunk) * -(-P // block)
    index = torch.arange(P, device=qc_s.device)
    later = index[:, None] > index[None, :]
    rows = []
    for s in range(0, S, chunk):
        qc, qr, valid = qc_s[s:s + chunk], qr_s[s:s + chunk], valid_s[s:s + chunk]
        qc_a, qr_a = qc[:, :, None, None], qr[:, :, None, None]
        qc_b, qr_b = qc[:, None, :, None], qr[:, None, :, None]
        pair_valid = valid[:, :, None, None] & valid[:, None, :, None]
        parts = []
        for i in range(0, P, block):
            qc_i, qr_i = qc[:, None, None, i:i + block], qr[:, None, None, i:i + block]
            cross2 = cross_product(qc_a, qr_a, qc_b, qr_b, qc_i, qr_i)
            spans = (qc_a <= qc_i) & (qc_i <= qc_b)
            strict = (qc_a < qc_i) & (qc_i < qc_b)
            hit = pair_valid & ((spans & (cross2 < 0)) | (strict & (cross2 == 0)))
            parts.append(hit.flatten(1, 2).any(dim=1))
        same_qc = qc[:, :, None] == qc[:, None, :]
        better = (qr[:, :, None] > qr[:, None, :]) | (
            (qr[:, :, None] == qr[:, None, :]) & later)
        vertical = (same_qc & better & valid[:, :, None]).any(dim=1)
        rows.append(torch.cat(parts, dim=1) | vertical)
    return torch.cat(rows)


def pareto_frontier(qr, qc, actions, budgets, budget: int = HULL_BUDGET) -> Frontier:
    """Top frontier of each state's (qc, qr) cloud: the dense hull of the
    JAX package. ``qr, qc, actions, budgets`` are ``[S, P]``, flattened over
    (budget x action) points; the comparison runs over blocks of states and
    points that hold at most ``budget`` elements each
    (``pareto_frontier.chunks`` counts the blocks of the last call)."""
    S, P = qr.shape
    device = qr.device
    order, qc_s, qr_s, valid_s = _sorted_cloud(qr, qc)
    on_hull = valid_s & ~_off_hull(qc_s, qr_s, valid_s, budget)
    pareto_frontier.chunks = _off_hull.blocks
    index = torch.arange(P, device=device)

    # hull points first, in qc order (a stable sort), the tail padded with the last
    rank = torch.argsort((~on_hull).to(torch.uint8), dim=-1, stable=True)
    count = on_hull.sum(dim=-1)
    hull_valid = index < count[:, None]
    last_rank = rank.gather(-1, (count - 1).clamp(min=0)[:, None])
    src = order.gather(-1, torch.where(hull_valid, rank, last_rank))
    return Frontier(qc=qc.gather(-1, src), qr=qr.gather(-1, src),
                    action=actions.gather(-1, src), budget=budgets.gather(-1, src),
                    valid=hull_valid, count=count)


def _pareto_frontier_chain(qr, qc, actions, budgets) -> Frontier:
    """The frontier of one state (``[P]`` inputs) by Andrew's monotone chain
    over the sorted valid points, popping while the turn is not strictly
    clockwise: the semantics that the dense hull reproduces. A plain loop,
    for the tests."""
    P = qr.shape[0]
    order, qc_s, qr_s, valid_s = (x[0] for x in _sorted_cloud(qr[None], qc[None]))
    stack = []
    for j in range(P):
        if not bool(valid_s[j]):
            continue
        while len(stack) >= 2 and float(cross_product(
                qc_s[stack[-2]], qr_s[stack[-2]], qc_s[stack[-1]], qr_s[stack[-1]],
                qc_s[j], qr_s[j])) >= 0:
            stack.pop()
        stack.append(j)
    top = len(stack)
    hull_idx = torch.tensor([stack[min(p, max(top - 1, 0))] if stack else 0 for p in range(P)],
                            dtype=torch.int64, device=qr.device)
    src = order[hull_idx]
    return Frontier(qc=qc[src], qr=qr[src], action=actions[src], budget=budgets[src],
                    valid=torch.arange(P, device=qr.device) < top,
                    count=torch.tensor(top, device=qr.device))


def optimal_mixture(frontier: Frontier, beta) -> Mixture:
    """Mixture of the two frontier points bracketing ``beta [S]`` in each
    state (reference: greedy_policy.py:16-36)."""
    n = frontier.count
    qc = torch.where(frontier.valid, frontier.qc, torch.inf)
    beta = beta.to(qc.dtype)
    # k: the first index with qc > beta, i.e. the count of qc <= beta
    k = torch.searchsorted(qc.contiguous(), beta[:, None].contiguous(), right=True)[:, 0]
    regular = (k >= 1) & (k < n)
    not_solvable = k < 1  # beta below the cheapest frontier point
    last = (n - 1).clamp(min=0)
    inf_idx = torch.minimum(torch.where(regular, k - 1, torch.where(not_solvable, 0, last)),
                            last).clamp(min=0)
    sup_idx = torch.minimum(torch.where(regular, k, torch.where(not_solvable, 0, last)),
                            last).clamp(min=0)

    def at(x, idx):
        return x.gather(-1, idx[:, None])[:, 0]

    qc_inf, qc_sup = at(frontier.qc, inf_idx), at(frontier.qc, sup_idx)
    denom = qc_sup - qc_inf
    p = torch.where(regular, (beta - qc_inf) / torch.where(denom != 0, denom, 1.0),
                    torch.where(not_solvable, 0.0, 1.0))
    return Mixture(
        action_inf=at(frontier.action, inf_idx), action_sup=at(frontier.action, sup_idx),
        budget_inf=at(frontier.budget, inf_idx), budget_sup=at(frontier.budget, sup_idx),
        qr_inf=at(frontier.qr, inf_idx), qr_sup=at(frontier.qr, sup_idx),
        qc_inf=qc_inf, qc_sup=qc_sup, probability_sup=p)


def frontier_values(qvalues, betas_disc, clamp_qc=None):
    """Split ``[S, B, 2A]`` Q-values into flattened frontier inputs, each
    ``[S, B * A]`` (reference point construction: greedy_policy.py:56-57)."""
    S, B, two_a = qvalues.shape
    A = two_a // 2
    qr = qvalues[..., :A].reshape(S, B * A)
    qc = qvalues[..., A:].reshape(S, B * A)
    if clamp_qc is not None:
        qc = torch.clamp(qc, clamp_qc[0], clamp_qc[1])
    actions = torch.arange(A, device=qvalues.device).repeat(B).expand(S, B * A)
    budgets = betas_disc.to(qvalues.dtype).repeat_interleave(A).expand(S, B * A)
    return qr, qc, actions, budgets


def batch_mixtures(qvalues, betas_disc, betas, budget: int = HULL_BUDGET) -> Mixture:
    """All states: ``[S, B, 2A]`` Q grids and a budget per state ``[S]`` ->
    the ``Mixture`` of each state."""
    qr, qc, actions, budgets = frontier_values(qvalues, betas_disc)
    return optimal_mixture(pareto_frontier(qr, qc, actions, budgets, budget), betas)
