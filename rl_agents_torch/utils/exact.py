"""Exact-rounding helpers for the parity planners, in float64.

Port of ``rl_agents_tpu/utils/exact.py``. The reference computes in Python
floats: one IEEE rounding per operation. The JAX package has to keep XLA from
contracting a product and a sum into one fused multiply-add; eager PyTorch
rounds every operation on its own already, so these are plain products and
sums. They must stay separate operations: never ``addcmul`` or another fused
call.
"""
from __future__ import annotations

import torch

KL_MAX_ITERATIONS = 100


def exact_mul(b, c):
    """``b * c``, rounded on its own."""
    return b * c


def mul_add_exact(a, b, c):
    """``a + b * c`` with two roundings (Python float semantics)."""
    return a + exact_mul(b, c)


def kl_upper_bound_exact(_sum, count, threshold, eps: float = 1e-2):
    """The reference's KL-UCB Newton solve (reference: rl_agents/utils.py:123-203)
    elementwise in float64: the stopping rule ``|x - x_next| > eps`` within
    100 iterations, the out-of-bounds pull-back with weight 0.9, the final
    clamp and the branches of ``bernoulli_kullback_leibler``. Each element
    stops on its own; the loop ends when none is left (one read-back a trip).
    """
    f64 = torch.float64
    _sum = torch.as_tensor(_sum, dtype=f64)
    count = torch.as_tensor(count, device=_sum.device).to(f64)
    threshold = torch.as_tensor(threshold, dtype=f64, device=_sum.device)
    mu = _sum / count
    max_div = threshold / count
    a = mu
    b = torch.ones_like(mu)
    weight, one_minus_weight = 0.9, 1.0 - 0.9
    p = mu

    def kl_f(q):
        kl1 = torch.where((p > 0) & (q > 0), exact_mul(p, torch.log(p / q)), 0.0)
        kl2 = torch.where(q < 1,
                          torch.where(p < 1, exact_mul(1 - p, torch.log((1 - p) / (1 - q))), 0.0),
                          torch.inf)
        return (kl1 + kl2) - max_div

    def dkl_f(q):
        return (1 - p) / (1 - q) - p / q

    x = torch.full_like(mu, torch.inf)
    x_next = (a + b) / 2
    active = torch.abs(x - x_next) > eps
    for _ in range(KL_MAX_ITERATIONS):
        if not bool(active.any()):
            break
        f_x = kl_f(x_next)
        df_x = dkl_f(x_next)
        stepped = torch.where(df_x != 0, x_next - f_x / df_x, x_next)
        pulled_a = exact_mul(weight, a) + exact_mul(one_minus_weight, x_next)
        pulled_b = exact_mul(weight, b) + exact_mul(one_minus_weight, x_next)
        stepped = torch.where(stepped < a, pulled_a, torch.where(stepped > b, pulled_b, stepped))
        x = torch.where(active, x_next, x)
        x_next = torch.where(active, stepped, x_next)
        active = active & (torch.abs(x - x_next) > eps)
    x_next = torch.where(x_next < a, a, torch.where(x_next > b, b, x_next))
    return torch.where(count == 0, 1.0, torch.where(a == b, a, x_next)).to(f64)
