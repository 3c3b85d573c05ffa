"""Optimizer and loss factories.

Port of ``rl_agents_tpu/models/optimizers.py`` (reference:
rl_agents/agents/common/optimizers.py:8-166). The update rules are written as
plain tensor functions that reproduce optax 0.2.6 exactly, in optax's shape:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, over lists of tensors in ``model.parameters()`` order, then
``apply_updates``. The state is a dict of tensors with its step count on the
device, so a whole update can be captured in a CUDA graph.

- ADAM: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root),
  ``optax.adamw`` when ``weight_decay`` is set;
- RMS_PROP: ``optax.rmsprop`` (decay 0.9, ``g * rsqrt(nu + 1e-8)``, initial
  scale 0). ``torch.optim.RMSprop`` differs in both;
- RANGER: ``scale_by_radam`` (threshold 5), then ``scale_by_trust_ratio``
  per parameter tensor, then ``scale(-lr)``, with ``add_decayed_weights``
  first when ``weight_decay`` is set.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Tensors = List[torch.Tensor]


def loss_function_factory(loss_function: str) -> Callable:
    if loss_function == "l2":
        return lambda pred, target: torch.mean((pred - target) ** 2)
    elif loss_function == "l1":
        return lambda pred, target: torch.mean(torch.abs(pred - target))
    elif loss_function == "smooth_l1":
        return lambda pred, target: torch.mean(huber_loss(pred, target))
    elif loss_function == "bce":
        return lambda pred, target: torch.mean(sigmoid_binary_cross_entropy(pred, target))
    raise ValueError(f"Unknown loss function: {loss_function}")


def huber_loss(pred, target, delta: float = 1.0):
    """``optax.huber_loss``: 0.5 e^2 inside ``delta``, linear beyond."""
    abs_errors = torch.abs(pred - target)
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


def sigmoid_binary_cross_entropy(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``: the loss takes logits."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _moment(grads: Tensors, moments: Tensors, decay: float, order: int) -> Tensors:
    """``(1 - decay) * g**order + decay * m`` (optax.tree.update_moment)."""
    powered = grads if order == 1 else torch._foreach_mul(grads, grads)
    return torch._foreach_add(torch._foreach_mul(powered, 1 - decay),
                              torch._foreach_mul(moments, decay))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 device scalar made by a fill, not a host copy (CUDA-graph safe)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _bias_correction(moments: Tensors, decay: float, count: torch.Tensor) -> Tensors:
    """``m / (1 - decay**count)`` with the power in float32, as optax takes it."""
    correction = 1 - torch.pow(_scalar(decay, count), count.to(torch.float32))
    return torch._foreach_div(moments, correction)


class GradientTransformation:
    """One optimizer: ``init`` and ``update`` as optax's, on tensor lists."""

    def __init__(self, init: Callable, update: Callable):
        self.init = init
        self.update = update


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return torch._foreach_add(params, updates)


def _scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    def update(grads, state, params=None):
        mu = _moment(grads, state["mu"], b1, 1)
        nu = _moment(grads, state["nu"], b2, 2)
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        updates = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        return updates, {"count": count, "mu": mu, "nu": nu}
    return update


def _scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(grads, state, params=None):
        mu = _moment(grads, state["mu"], b1, 1)
        nu = _moment(grads, state["nu"], b2, 2)
        count = state["count"] + 1
        count_f = count.to(torch.float32)
        b2t = torch.pow(_scalar(b2, count), count_f)
        ro = ro_inf - 2 * count_f * b2t / (1 - b2t)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rectified = torch._foreach_div(torch._foreach_mul(mu_hat, r),
                                       torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        use = ro >= threshold
        updates = [torch.where(use, t, f) for t, f in zip(rectified, mu_hat)]
        return updates, {"count": count, "mu": mu, "nu": nu}
    return update


def _scale_by_trust_ratio(updates: Tensors, params: Tensors) -> Tensors:
    """Per tensor: ``u * ||p|| / ||u||``, and ``u`` where either norm is 0."""
    scaled = []
    for u, p in zip(updates, params):
        param_norm, update_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        zero = (param_norm == 0.0) | (update_norm == 0.0)
        ratio = torch.where(zero, torch.ones_like(param_norm), param_norm / update_norm)
        scaled.append(u * ratio)
    return scaled


def optimizer_factory(optimizer_type: str, lr: float = 5e-4, weight_decay: float = 0.0,
                      **kwargs) -> GradientTransformation:
    if optimizer_type == "ADAM":
        adam = _scale_by_adam()

        def init(params):
            return {"count": _count(params), "mu": _zeros(params), "nu": _zeros(params)}

        def update(grads, state, params):
            updates, state = adam(grads, state)
            if weight_decay:
                updates = torch._foreach_add(updates, torch._foreach_mul(params, weight_decay))
            return torch._foreach_mul(updates, -lr), state
        return GradientTransformation(init, update)
    elif optimizer_type == "RMS_PROP":
        decay, eps = 0.9, 1e-8

        def init(params):
            return {"nu": _zeros(params)}

        def update(grads, state, params):
            nu = _moment(grads, state["nu"], decay, 2)
            scaling = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
            updates = torch._foreach_mul(scaling, grads)
            return torch._foreach_mul(updates, -lr), {"nu": nu}
        return GradientTransformation(init, update)
    elif optimizer_type == "RANGER":
        radam = _scale_by_radam()

        def init(params):
            return {"count": _count(params), "mu": _zeros(params), "nu": _zeros(params)}

        def update(grads, state, params):
            if weight_decay:
                grads = torch._foreach_add(grads, torch._foreach_mul(params, weight_decay))
            updates, state = radam(grads, state)
            updates = _scale_by_trust_ratio(updates, params)
            return torch._foreach_mul(updates, -lr), state
        return GradientTransformation(init, update)
    raise ValueError(f"Unknown optimizer type: {optimizer_type}")
