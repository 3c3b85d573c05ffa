"""KL confidence-bound math in PyTorch.

Port of the Bernoulli-KL part of ``rl_agents_tpu/utils/math.py`` (reference:
rl_agents/utils.py:43-203). The batched solve itself lives in
``rl_agents_torch/ops/kl_bound.py``; these are the elementwise pieces it and
the planners share.

``torch.where`` evaluates both branches, so the guarded logs below keep their
inner ``where``s: without them the kept branch would pick up ``nan``/``inf``
from ``log(0)`` through the arithmetic of the dropped one.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

NEWTON_MAX_ITERATIONS = 100
NEWTON_OOB_WEIGHT = 0.9  # out-of-bounds relaxation weight (reference utils.py:151)


def near_split(x: int, num_bins: int | None = None, size_bins: int | None = None) -> List[int]:
    """Split an integer into near-even bins (reference utils.py:43-58)."""
    if num_bins:
        quotient, remainder = divmod(x, num_bins)
        return [quotient + 1] * remainder + [quotient] * (num_bins - remainder)
    elif size_bins:
        return near_split(x, num_bins=int(np.ceil(x / size_bins)))
    return []


def bernoulli_kullback_leibler(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(B(p) || B(q)) (reference utils.py:89-107)."""
    kl1 = torch.where((p > 0) & (q > 0),
                      p * torch.log(torch.where(q > 0, p / torch.where(q > 0, q, 1.0), 1.0)),
                      0.0)
    log_ratio = torch.log(torch.where((p < 1) & (q < 1),
                                      (1 - p) / torch.where(q < 1, 1 - q, 1.0), 1.0))
    kl2 = torch.where(q < 1, torch.where(p < 1, (1 - p) * log_ratio, 0.0),
                      torch.where(p < 1, torch.inf, 0.0))
    # q == 0 with p > 0: p*log(p/0) = inf
    kl1 = torch.where((p > 0) & (q <= 0), torch.inf, kl1)
    return kl1 + kl2


def d_bernoulli_kullback_leibler_dq(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dKL/dq (B(p)||B(q)) (reference utils.py:110-120)."""
    return (1 - p) / (1 - q) - p / q


def _bounded_newton_step(x, f_x, df_x, a, b):
    """One guarded Newton step with the reference's out-of-bounds relaxation
    (utils.py:191-195): overshoots are pulled back towards the violated bound."""
    x_next = torch.where(df_x != 0, x - f_x / df_x, x)
    x_next = torch.where(torch.isfinite(x_next), x_next, x)
    w = NEWTON_OOB_WEIGHT
    x_next = torch.where(x_next < a, w * a + (1 - w) * x, x_next)
    x_next = torch.where(x_next > b, w * b + (1 - w) * x, x_next)
    return x_next
