"""Plain reference of MDP-GapE (Jonsson, Kaufmann, Ménard, Darwiche Domingues,
Leurent and Valko, "Planning in Markov decision processes with gap-dependent
sample complexity", NeurIPS 2020), as eleurent/rl-agents implements it
(``agents/tree_search/mdp_gape.py``, the constrained expectation in
``agents/common/utils.py:292-342``). Each tree plans from its own start
state; a plan runs up to ``episodes + 1`` episodes of ``horizon`` steps:

- the root's action is UGapE's: the best arm ``b`` has the least gap
  ``max_{j != b} U_j - L_b``, the challenger ``c`` the largest ``U`` among
  the others, and the episode samples ``b`` where ``U_b - L_b >= U_c - L_c``,
  else ``c``; below the root the optimistic action, the largest chance
  value ``U``, ties broken at random;
- a decision node is expanded, when first reached, into one chance node an
  action, whose value bounds start at ``[0, (1 - gamma^k) / (1 - gamma)]``
  with ``k`` the steps left; a chance node holds at most ``width`` next
  states, told apart by their observation, each a decision node holding the
  (state, action, next state) reward's count and sum; the step's reward
  goes to that node (0 once a terminal state was reached);
- after the descent, every node of the path gets the KL-UCB and KL-LCB of
  its mean reward, ``KL <= c / n`` at its count ``n``, where ``c`` is the
  configuration's ``upper_bound.threshold`` evaluated as upstream evaluates
  it (``threshold``: Python's ``eval`` with ``np``, ``horizon``,
  ``actions``, ``confidence``, ``count`` and ``time``, the budget's
  episodes; its default ``3*np.log(1 + np.log(count)) + ...`` divides by
  zero at confidence 1.0, as upstream's does), then the path is backed
  up from the leaf: a decision node takes the largest bounds of its chance
  nodes (0 at the horizon), a chance node ``max_p E_p[mu_ucb + gamma U]``
  and ``min_p E_p[mu_lcb + gamma L]`` over the next-state distributions
  ``p`` with ``KL(p_hat || p) <= 0.1 log(episodes) / n``, where an unfilled
  slot counts as a next state of probability 0, with ``[0, 1]`` reward and
  vacuous value bounds;
- a tree stops once ``U_c - L_b < accuracy``; the plan's action is the
  best arm.

Every random choice is an argmax over given Gumbel draws: ``noise [E + 1,
H, B, A]`` breaks the ties of the optimistic action (the tied action of
largest draw), ``env_noise [E + 1, H, B, K]`` is the garnet's categorical
draw (``garnet.py``).

Three choices follow the program where the published code leaves them
open, each a layout and none a semantics. Arena: nodes are slots of
fixed arrays, decision node 0 the root, each new decision node the next
slot (``1 + (episodes + 1) * horizon`` of them, enough for every insert),
each expansion the next ``A`` chance slots. Observations: a next state's
key is its index hashed as the program hashes observations (``state_key``),
since the comparison is slot by slot. A next state not seen while the
chance node's slots are full goes to its last slot (never on the garnet,
whose ``branching`` equals the width). Constants: the value bound of ``k``
steps left is tabulated with float32 powers, each ``mu + gamma v`` rounds
once (``rounding.fused``), and the transitions' ``0.1 log(episodes)`` is
a float32 product, as the program's are; the reward threshold is
evaluated in float64 and rounded to float32 once.

Many trees at once, one row each. Plain PyTorch; imports nothing of the
program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import kl
from perfbench.reference.rounding import fused

NEWTON_EPS = 1e-2
NEWTON_ITERS = 100
OUT_OF_BOUNDS_WEIGHT = 0.9
PRECISION = 1e-4   # the observation's quantum before hashing
MASK32 = 0xFFFFFFFF


class Tree(NamedTuple):
    d_parent: torch.Tensor       # [B, Nd] int64 chance parent, -1 at the root and free slots
    d_depth: torch.Tensor        # [B, Nd] int64
    d_count: torch.Tensor        # [B, Nd] int64 visits
    d_cum_reward: torch.Tensor   # [B, Nd] reward sum
    d_mu_ucb: torch.Tensor       # [B, Nd] KL-UCB of the mean reward
    d_mu_lcb: torch.Tensor       # [B, Nd] KL-LCB
    d_value_upper: torch.Tensor  # [B, Nd]
    d_value_lower: torch.Tensor  # [B, Nd]
    d_children: torch.Tensor     # [B, Nd, A] int64 chance ids, -1 before expansion
    d_done: torch.Tensor         # [B, Nd] bool
    c_parent: torch.Tensor       # [B, Nc] int64
    c_depth: torch.Tensor        # [B, Nc] int64
    c_count: torch.Tensor        # [B, Nc] int64
    c_value_upper: torch.Tensor  # [B, Nc]
    c_value_lower: torch.Tensor  # [B, Nc]
    c_child_keys: torch.Tensor   # [B, Nc, W] int64 observation keys
    c_children: torch.Tensor     # [B, Nc, W] int64 decision ids, -1 where unfilled
    c_n_children: torch.Tensor   # [B, Nc] int64
    d_used: torch.Tensor         # [B] int64
    c_used: torch.Tensor         # [B] int64


def state_key(s: int) -> int:
    """The 32-bit key of the observation ``s`` (a state index): the index
    quantised to ``PRECISION`` in float32, rounded half to even, times the
    odd position multiplier 2654435761, then murmur3's fmix32; 0 is kept
    free."""
    q = int(np.round(np.float32(s) * (np.float32(1) / np.float32(PRECISION)))) & MASK32
    h = (q * 2654435761) & MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return max(h, 1)


def lower_bound(total, count, threshold):
    """KL-LCB of ``total / count``: ``KL(mu, q) = threshold / count`` for q in
    [0, mu], by ``kl.py``'s guarded Newton steps from the middle of the
    interval; a count of 0 gives 0."""
    safe = torch.clamp(count, min=1.0)
    mu = total / safe
    max_div = threshold / safe
    a, b = torch.zeros_like(mu), mu
    x = (a + b) / 2
    frozen = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    w = kl.OUT_OF_BOUNDS_WEIGHT
    for _ in range(kl.ITERS):
        f_x = kl.bernoulli_kl(mu, x) - max_div
        df_x = kl.bernoulli_kl_dq(mu, x)
        step = torch.where(df_x != 0, x - f_x / df_x, x)
        step = torch.where(torch.isfinite(step), step, x)
        step = torch.where(step < a, w * a + (1 - w) * x, step)
        step = torch.where(step > b, w * b + (1 - w) * x, step)
        newly = torch.abs(step - x) <= kl.EPS
        x = torch.where(frozen, x, step)
        frozen = frozen | newly
        if bool(frozen.all()):
            break
    x = torch.minimum(torch.maximum(x, a), b)
    x = torch.where(a == b, a, x)
    return torch.where(count == 0, 0.0, x).to(total.dtype)


def max_expectation(f, q, c):
    """``argmax_p E_p[f]`` subject to ``KL(q || p) <= c``, one problem a row
    (``f``, ``q`` ``[N, n]``, ``c`` ``[N]``), by upstream's cases:

    - a row of q all 0 is taken as uniform;
    - where the largest f lies only on atoms of q's zero mass and
      ``theta(f*) < 0``, the mass ``z = 1 - exp(theta(f*))`` goes to the
      zero-mass atoms of largest f, and lambda = f*;
    - where f is constant (``isclose``) on q's support, p = q;
    - otherwise lambda solves ``theta(lambda) = 0`` for lambda >= f* by
      guarded Newton steps from f* + 1 (step 0.01, at most 100 trips);

    then ``p = (1 - z) q / (lambda - f) / sum_i q_i / (lambda - f_i)`` on the
    support, or, where that scale is 0, ``1 - z`` shared by its atoms of
    largest f. ``theta(l) = sum q log(l - f) + log sum q / (l - f) - c``
    over the support, each ``l - f`` at least 1e-12."""
    n = q.shape[-1]
    if n == 1:
        return torch.ones_like(q)
    q = torch.where((q == 0).all(dim=-1, keepdim=True), torch.ones_like(q) / n, q)
    support = q > 0
    q_s = torch.where(support, q, 0.0)
    f_star = f.amax(dim=-1)
    f_support_max = torch.where(support, f, -torch.inf).amax(dim=-1)

    def gaps(lam):
        return torch.clamp(torch.where(support, lam[..., None] - f, 1.0), min=1e-12)

    def theta(lam):
        d = gaps(lam)
        first = torch.where(support, q_s * torch.log(d), 0.0).sum(dim=-1)
        second = torch.where(support, q_s / d, 0.0).sum(dim=-1)
        return first + torch.log(torch.clamp(second, min=0.0)) - c

    def theta_slope(lam):
        d = gaps(lam)
        ratio = torch.where(support, q_s / d, 0.0)
        total = ratio.sum(dim=-1)
        return total - (ratio / d).sum(dim=-1) / torch.clamp(total, min=0.0)

    theta_star = theta(f_star)
    on_zero_mass = (f_star > f_support_max) & (theta_star < 0)
    z = torch.where(on_zero_mass, 1.0 - torch.exp(theta_star), 0.0)
    zero_top = ~support & (f == torch.where(~support, f, -torch.inf).amax(dim=-1, keepdim=True))
    zero_top_n = torch.clamp(zero_top.sum(dim=-1).to(f.dtype), min=1.0)
    p_zero = torch.where(on_zero_mass[..., None] & zero_top, (z / zero_top_n)[..., None], 0.0)

    first_support = support.to(torch.int64).argmax(dim=-1, keepdim=True)
    constant = torch.where(support, torch.isclose(f, f.gather(-1, first_support)), True).all(dim=-1)

    lam = torch.where(on_zero_mass, f_star, newton(theta, theta_slope, f_star + 1.0, f_star))
    d = gaps(lam)
    total = torch.where(support, q_s / d, 0.0).sum(dim=-1)
    scale = ((1.0 - z) / torch.clamp(total, min=0.0))[..., None]
    top = support & (f == f_star[..., None])
    top_n = torch.clamp(top.sum(dim=-1).to(f.dtype), min=1.0)
    p_support = torch.where(scale <= 0, torch.where(top, ((1.0 - z) / top_n)[..., None], 0.0),
                            torch.where(support, scale * q_s / d, 0.0))
    return torch.where((constant & ~on_zero_mass)[..., None], q, p_support + p_zero)


def newton(f, df, x0, a):
    """The zero of ``f`` on ``[a, inf)`` by Newton steps from ``x0`` (upstream
    ``newton_iteration``): each row stops once a step moves it by ``NEWTON_EPS``
    or less (that step taken); a step that leaves the interval, or is not
    finite, is pulled back with the weight 0.9; at most ``NEWTON_ITERS``
    steps."""
    x_next = x0
    x = torch.full_like(x0, torch.inf)
    w = OUT_OF_BOUNDS_WEIGHT
    for _ in range(NEWTON_ITERS):
        moving = torch.abs(x - x_next) > NEWTON_EPS
        if not bool(moving.any()):
            break
        f_x, df_x = f(x_next), df(x_next)
        step = torch.where(df_x != 0, x_next - f_x / df_x, x_next)
        step = torch.where(torch.isfinite(step), step, x_next)
        step = torch.where(step < a, w * a + (1 - w) * x_next, step)
        x = torch.where(moving, x_next, x)
        x_next = torch.where(moving, step, x_next)
    return torch.maximum(x_next, a)


# upstream's default ``upper_bound.threshold``
DEFAULT_THRESHOLD = ("3*np.log(1 + np.log(count))"
                     "+ horizon*np.log(actions)"
                     "+ np.log(1/(1-confidence))")


def reward_thresholds(spec: str, counts: int, horizon: int, num_actions: int, confidence: float,
                      episodes: int, device) -> torch.Tensor:
    """The reward threshold ``spec`` at each count ``0 .. counts - 1`` (at
    least 1), as upstream's decision node evaluates ``upper_bound.threshold``
    (``time`` is the budget's episodes); float32."""
    return torch.tensor(
        [float(eval(spec, {"np": np}, {"horizon": horizon, "actions": num_actions,
                                      "confidence": confidence, "count": max(n, 1),
                                      "time": episodes}))
         for n in range(counts)], dtype=torch.float32, device=device)


def plan(env, model, starts, noise, env_noise, *, num_actions: int, episodes: int,
         horizon: int, width: int, gamma: float, accuracy: float, confidence: float,
         threshold: str, transition_threshold_coeff: float, dtype=torch.float32):
    """Plan one tree from each start state. ``env`` is the env's plain
    reference (its ``transition``), ``starts`` its state ``[B]``,
    ``threshold`` the configuration's ``upper_bound.threshold``. Returns
    ``(best action [B], episodes run [B], Tree)``."""
    A, W, H, E = num_actions, width, horizon, episodes
    dev = starts.s.device
    B = starts.s.shape[0]
    Nd = 1 + (E + 1) * H
    Nc = 1 + Nd * A
    i64 = torch.int64
    rows = torch.arange(B, device=dev)
    g32 = np.float32(gamma)
    bound_left = torch.tensor([(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32)
                               for k in range(H + 1)], dtype=torch.float32, device=dev).to(dtype)
    gamma_ = torch.tensor(g32, device=dev).to(dtype)
    thresholds = reward_thresholds(threshold, E + 2, H, A, confidence, E, dev).to(dtype)
    transition_threshold = (torch.tensor(transition_threshold_coeff, dtype=torch.float32,
                                         device=dev)
                            * torch.log(torch.tensor(float(E), dtype=torch.float32,
                                                     device=dev))).to(dtype)
    keys = torch.tensor([state_key(s) for s in range(model.num_states)], dtype=i64, device=dev)
    noise = noise.to(device=dev, dtype=torch.float32).to(dtype)
    env_noise = env_noise.to(device=dev, dtype=torch.float32).to(dtype)

    def upper_at(depth):
        return bound_left[(H - depth).clamp(min=0)]

    def filled(shape, value, kind=dtype):
        return torch.full(shape, value, dtype=kind, device=dev)

    t = Tree(
        d_parent=filled((B, Nd), -1, i64), d_depth=filled((B, Nd), 0, i64),
        d_count=filled((B, Nd), 0, i64), d_cum_reward=filled((B, Nd), 0.0),
        d_mu_ucb=filled((B, Nd), 1.0), d_mu_lcb=filled((B, Nd), 0.0),
        d_value_upper=bound_left[H].expand(B, Nd).clone(), d_value_lower=filled((B, Nd), 0.0),
        d_children=filled((B, Nd, A), -1, i64), d_done=filled((B, Nd), False, torch.bool),
        c_parent=filled((B, Nc), -1, i64), c_depth=filled((B, Nc), 0, i64),
        c_count=filled((B, Nc), 0, i64), c_value_upper=bound_left[H].expand(B, Nc).clone(),
        c_value_lower=filled((B, Nc), 0.0), c_child_keys=filled((B, Nc, W), 0, i64),
        c_children=filled((B, Nc, W), -1, i64), c_n_children=filled((B, Nc), 0, i64),
        d_used=filled((B,), 1, i64), c_used=filled((B,), 0, i64))

    def write(arena, where_, value, on):
        """arena[b, where_[b]] = value[b] for the rows ``on``."""
        at = (rows, *where_) if isinstance(where_, tuple) else (rows, where_)
        arena[at] = torch.where(on, value, arena[at])

    def of_children(values, ids, missing):
        return torch.where(ids >= 0, values.gather(1, ids.clamp(min=0)), missing)

    def expand(node, on):
        grow = on & (t.d_children[rows, node, 0] < 0)
        ids = t.c_used[:, None] + torch.arange(A, device=dev)
        t.d_children[rows, node] = torch.where(grow[:, None], ids, t.d_children[rows, node])
        for k in range(A):  # the new chance nodes, one action at a time
            at = ids[:, k].clamp(max=Nc - 1)
            write(t.c_parent, at, node, grow)
            write(t.c_depth, at, t.d_depth[rows, node], grow)
            write(t.c_value_upper, at, upper_at(t.d_depth[rows, node]), grow)
        t.c_used.add_(A * grow.to(i64))

    def ugape():
        """(sampled arm, best arm, challenger, U_c - L_b) at the root."""
        ids = t.d_children[:, 0]
        up = of_children(t.c_value_upper, ids, -torch.inf)
        lo = of_children(t.c_value_lower, ids, torch.inf)
        others = ~torch.eye(A, dtype=torch.bool, device=dev)
        best_other = torch.where(others, up[:, None, :], -torch.inf).amax(dim=-1)
        gap = torch.where(ids >= 0, best_other - lo, torch.inf)
        best = gap.argmin(dim=1)
        not_best = (ids >= 0) & (torch.arange(A, device=dev) != best[:, None])
        challenger = torch.where(not_best, up, -torch.inf).argmax(dim=1)
        at = lambda x, k: x[rows, k]
        sampled = torch.where(at(up, best) - at(lo, best) >= at(up, challenger) - at(lo, challenger),
                              best, challenger)
        return sampled, best, challenger, at(up, challenger) - at(lo, best)

    def back_decision(node, on):
        ids = t.d_children[rows, node]
        leaf = (ids < 0).all(dim=1)
        up = of_children(t.c_value_upper, ids, -torch.inf).amax(dim=1)
        lo = of_children(t.c_value_lower, ids, -torch.inf).amax(dim=1)
        write(t.d_value_upper, node, torch.where(leaf, 0.0, up), on)
        write(t.d_value_lower, node, torch.where(leaf, 0.0, lo), on)

    def back_chance(chance, on):
        ids = t.c_children[rows, chance]
        unfilled = ids < 0
        n = of_children(t.d_count, ids, 0)
        mu_up = of_children(t.d_mu_ucb, ids, 1.0)
        mu_lo = of_children(t.d_mu_lcb, ids, 0.0)
        v_up = torch.where(unfilled, upper_at(t.c_depth[rows, chance] + 1)[:, None],
                           t.d_value_upper.gather(1, ids.clamp(min=0)))
        v_lo = of_children(t.d_value_lower, ids, 0.0)
        visits = torch.clamp(t.c_count[rows, chance].to(dtype), min=1.0)
        p_hat = n.to(dtype) / visits[:, None]
        budget = transition_threshold / visits
        upper = fused(gamma_, v_up, mu_up, dtype)
        lower = fused(gamma_, v_lo, mu_lo, dtype)
        p_up = max_expectation(upper, p_hat, budget)
        p_lo = max_expectation(-lower, p_hat, budget)
        write(t.c_value_upper, chance, (p_up * upper).sum(dim=1), on)
        write(t.c_value_lower, chance, (p_lo * lower).sum(dim=1), on)

    live = torch.ones(B, dtype=torch.bool, device=dev)
    ran = torch.zeros(B, dtype=i64, device=dev)
    root = torch.zeros(B, dtype=i64, device=dev)
    for episode in range(E + 1):
        expand(root, live)
        sampled = ugape()[0]
        node, state = root, starts
        path = []
        for h in range(H):
            expand(node, live)
            ids = t.d_children[rows, node]
            up = of_children(t.c_value_upper, ids, -torch.inf)
            tied = (ids >= 0) & (up == up.amax(dim=1, keepdim=True))
            optimistic = torch.where(tied, noise[episode, h], -torch.inf).argmax(dim=1)
            action = sampled if h == 0 else optimistic
            chance = ids[rows, action].clamp(min=0)
            state, reward, terminated = env.transition(model, state, action,
                                                       env_noise[episode, h], dtype)

            key = keys[state.s]
            n = t.c_n_children[rows, chance]
            seen = (t.c_child_keys[rows, chance] == key[:, None]) \
                & (torch.arange(W, device=dev) < n[:, None])
            found = seen.any(dim=1)
            slot = torch.where(found, seen.to(i64).argmax(dim=1), (n - 1).clamp(min=0))
            new = ~found & (n < W) & live
            slot = torch.where(new, n, slot)
            fresh = t.d_used.clamp(max=Nd - 1)
            child = torch.where(new, fresh, t.c_children[rows, chance, slot].clamp(min=0))
            write(t.c_child_keys, (chance, slot), key, new)
            write(t.c_children, (chance, slot), fresh, new)
            write(t.c_n_children, chance, n + 1, new)
            write(t.d_parent, fresh, chance, new)
            write(t.d_depth, fresh, t.c_depth[rows, chance] + 1, new)
            write(t.d_value_upper, fresh, upper_at(t.c_depth[rows, chance] + 1), new)
            t.d_used.add_(new.to(i64))

            done = terminated | t.d_done[rows, child]
            write(t.c_count, chance, t.c_count[rows, chance] + 1, live)
            write(t.d_count, child, t.d_count[rows, child] + 1, live)
            write(t.d_cum_reward, child,
                  t.d_cum_reward[rows, child] + torch.where(done, 0.0, reward), live)
            write(t.d_done, child, done, live)
            path.append(child)
            node = child

        for child in path:  # distinct depths: each node's bounds from its own statistics
            count = t.d_count[rows, child]
            total = t.d_cum_reward[rows, child]
            threshold = thresholds[count.clamp(max=E + 1)]
            write(t.d_mu_ucb, child, kl.upper_bound(total, count.to(dtype), threshold), live)
            write(t.d_mu_lcb, child, lower_bound(total, count.to(dtype), threshold), live)

        for child in reversed(path):
            back_decision(child, live)
            back_chance(t.d_parent[rows, child].clamp(min=0), live)
        back_decision(root, live)

        gap = ugape()[3]
        ran = ran + live.to(i64)
        live = live & ~(gap < accuracy)

    return ugape()[1], ran, t
