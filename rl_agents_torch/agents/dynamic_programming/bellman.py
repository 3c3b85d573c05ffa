"""Bellman backups: value iteration as fixed points over tensors.

Port of ``rl_agents_tpu/agents/dynamic_programming/bellman.py`` (reference:
dynamic_programming/value_iteration.py:37-73 and
robust_value_iteration.py:32-58). The Bellman expectation takes a finite MDP
in one of three encodings: deterministic (a gather), stochastic (the
``[S, A, S] x [S]`` contraction, a ``torch.einsum``, whose summation order
is not XLA's, so its result agrees within float tolerance) and sparse (a
gather and a weighted sum over the K successors, written as XLA computes
it, so that it is equal). Every function also takes models with leading axes
(the robust agent's model set), since each operation broadcasts over them.

The fixed point keeps the JAX package's stopping rule exactly: at most
``iterations`` updates, stopping at the first update that is ``allclose`` to
its predecessor (``|q - q_next| <= atol + rtol * |q_next|``) and returning
the iterate from before that update. Each iteration reads the convergence
flag back to the host once.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rl_agents_torch.utils.math import fma


class BellmanModel(NamedTuple):
    """One finite MDP (or a stack of them) in any of the three encodings."""

    transition: Any  # [..., S, A] i64 | [..., S, A, S] f32 | [..., S, A, K] f32
    reward: Any      # [..., S, A] f32
    terminal: Any    # [..., S] bool
    next: Any        # [..., S, A, K] i64 (sparse only; else a scalar)


def bellman_expectation(model: BellmanModel, value, gamma, mode: str):
    """Q(s, a) = R(s, a) + gamma * E[V(s')], with V zeroed at terminal states
    (reference: value_iteration.py:51-63). ``reward + gamma * next_v`` is one
    fused multiply-add in the JAX package on the CPU."""
    if mode == "deterministic":
        next_v = value[model.transition]
    elif mode == "stochastic":
        next_v = torch.einsum("...sap,p->...sa", model.transition, value)
    elif mode == "sparse":
        # XLA reduces the K successors in order, one fused multiply-add each
        weights, values = model.transition, value[model.next]
        next_v = weights[..., 0] * values[..., 0]
        for k in range(1, weights.shape[-1]):
            next_v = fma(weights[..., k], values[..., k], next_v)
    else:
        raise ValueError(f"Unknown mode {mode}")
    next_v = torch.where(model.terminal[..., None], 0.0, next_v)
    gamma = torch.full((), float(gamma), dtype=torch.float32, device=next_v.device)
    return fma(gamma, next_v, model.reward)


def allclose(q, q_next, rtol: float, atol: float) -> torch.Tensor:
    """``jnp.allclose(q, q_next)`` as a device scalar: the tolerance is taken
    on ``q_next``, ``atol + rtol * |q_next|`` rounded once as XLA fuses it,
    and equal infinities are close."""
    f32 = torch.float32
    bound = fma(torch.full((), rtol, dtype=f32, device=q.device), q_next.abs(),
                torch.full((), atol, dtype=f32, device=q.device))
    close = (q - q_next).abs() <= bound
    infinite = torch.isinf(q) | torch.isinf(q_next)
    return torch.where(infinite, q == q_next, close).all()


def _fixed_point(operator, q0, iterations: int, rtol: float, atol: float):
    """``(q, updates)``: the iterate and the number of updates computed."""
    q = q0
    for update in range(1, iterations + 1):
        q_next = operator(q)
        if bool(allclose(q, q_next, rtol, atol)):
            return q, update
        q = q_next
    return q, iterations


def state_action_value(model: BellmanModel, gamma, mode: str, iterations: int = 100,
                       rtol: float = 1e-5, atol: float = 1e-8):
    """Fixed-point iteration for Q* (reference: value_iteration.py:42-45,65-73).
    ``state_action_value.iterations`` holds the number of updates the last
    call computed."""
    q, state_action_value.iterations = _fixed_point(
        lambda q: bellman_expectation(model, q.amax(dim=-1), gamma, mode),
        torch.zeros_like(model.reward), iterations, rtol, atol)
    return q


def robust_state_action_value(models: BellmanModel, gamma, mode: str, iterations: int = 100,
                              rtol: float = 1e-5, atol: float = 1e-8):
    """Robust Q over a rectangular model set: the minimum over the leading
    model axis of the per-model Bellman expectations, inside the fixed point
    (reference: robust_value_iteration.py:39-48). ``.iterations`` as for
    ``state_action_value``."""
    q0 = torch.zeros(models.reward.shape[1:], dtype=models.reward.dtype,
                     device=models.reward.device)
    q, robust_state_action_value.iterations = _fixed_point(
        lambda q: bellman_expectation(models, q.amax(dim=-1), gamma, mode).amin(dim=0),
        q0, iterations, rtol, atol)
    return q


def plan_trajectory(model: BellmanModel, q, state, mode: str, horizon: int = 10):
    """Greedy rollout from Q (reference: value_iteration.py:84-96) for
    deterministic transitions (else the most likely next state). Returns
    ``(states, actions)``, each ``[horizon]``, padded with -1 after a
    terminal state."""
    s = torch.as_tensor(state, dtype=torch.int64, device=q.device).reshape(())
    live = torch.ones((), dtype=torch.bool, device=q.device)
    states, actions = [], []
    for _ in range(horizon):
        a = q[s].argmax()
        s_next = model.transition[s, a] if mode == "deterministic" \
            else model.transition[s, a].argmax()
        states.append(torch.where(live, s, -1))
        actions.append(torch.where(live, a, -1))
        live = live & ~model.terminal[s_next]
        s = s_next
    return torch.stack(states), torch.stack(actions)
