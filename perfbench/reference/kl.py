"""Plain reference of the KL upper confidence bound of a Bernoulli mean.

Solves ``KL(mu, q) = threshold / count`` for ``q`` in ``[mu, 1]`` by guarded
Newton steps from the middle of the interval. Each element stops at the
trip whose step moves it by ``EPS`` (0.01) or less (that step is taken); a step
that leaves the interval is pulled back towards the violated end with the
weight 0.9; at most ``ITERS`` (100) trips. A count of 0 gives 1. Plain PyTorch;
imports nothing of the program.
"""
from __future__ import annotations

import torch

OUT_OF_BOUNDS_WEIGHT = 0.9
ITERS = 100
EPS = 1e-2


def bernoulli_kl(p, q):
    """KL(B(p) || B(q)), with p log(p / 0) = inf."""
    kl1 = torch.where((p > 0) & (q > 0),
                      p * torch.log(torch.where(q > 0, p / torch.where(q > 0, q, 1.0), 1.0)),
                      0.0)
    log_ratio = torch.log(torch.where((p < 1) & (q < 1),
                                      (1 - p) / torch.where(q < 1, 1 - q, 1.0), 1.0))
    kl2 = torch.where(q < 1, torch.where(p < 1, (1 - p) * log_ratio, 0.0),
                      torch.where(p < 1, torch.inf, 0.0))
    kl1 = torch.where((p > 0) & (q <= 0), torch.inf, kl1)
    return kl1 + kl2


def bernoulli_kl_dq(p, q):
    return (1 - p) / (1 - q) - p / q


def upper_bound(total, count, threshold):
    """The bound of elementwise ``total / count`` (float tensors of one shape;
    ``threshold`` a 0-d tensor of their dtype)."""
    safe = torch.clamp(count, min=1.0)
    mu = total / safe
    max_div = threshold / safe
    a, b = mu, torch.ones_like(mu)
    x = (a + b) / 2
    frozen = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    w = OUT_OF_BOUNDS_WEIGHT
    for _ in range(ITERS):
        f_x = bernoulli_kl(mu, x) - max_div
        df_x = bernoulli_kl_dq(mu, x)
        step = torch.where(df_x != 0, x - f_x / df_x, x)
        step = torch.where(torch.isfinite(step), step, x)
        step = torch.where(step < a, w * a + (1 - w) * x, step)
        step = torch.where(step > b, w * b + (1 - w) * x, step)
        newly = torch.abs(step - x) <= EPS
        x = torch.where(frozen, x, step)
        frozen = frozen | newly
        if bool(frozen.all()):
            break
    x = torch.minimum(torch.maximum(x, a), b)
    x = torch.where(a == b, a, x)
    return torch.where(count == 0, 1.0, x).to(total.dtype)
