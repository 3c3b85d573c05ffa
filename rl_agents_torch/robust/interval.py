"""Interval prediction for linear systems with polytopic uncertainty,
batch-first.

Port of ``rl_agents_tpu/robust/interval.py`` (reference: robust_epc.py:144-150
delegates to highway_env.interval.LPV). The interval predictor for

    dx/dt = A(theta) x + B u + D omega,   A(theta) in {A0 + sum_k alpha_k dA_k}

decomposes into positive and negative parts (an Efimov-style interval
observer): with [A_lo, A_hi] the elementwise interval of A(theta) over
alpha in [0, 1]^K,

    dxl = Al+ xl+ - Ah+ xl- - Al- xh+ + Ah- xh- + B u + D wl
    dxh = Ah+ xh+ - Al+ xh- - Ah- xl+ + Al- xl- + B u + D wh

keeps xl <= x <= xh for every admissible theta and omega, under Euler steps.
Here ``x_lo`` and ``x_hi`` carry a leading batch axis ``[B, p]`` and the
matrices may too (``[B, p, p]``) or not (``[p, p]``): every product is one
``torch.einsum`` over the batch.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, matvec, matvec_add, neg, pos


class LPV(NamedTuple):
    """Polytopic linear parameter-varying system with an interval state."""

    a0: Any        # [..., p, p] nominal dynamics
    da: Any        # [..., K, p, p] uncertainty vertices (alpha_k in [0, 1])
    b: Any         # [..., p, q] control matrix
    d: Any         # [..., p, r] perturbation matrix
    omega_lo: Any  # [..., r] perturbation lower bound
    omega_hi: Any  # [..., r] perturbation upper bound
    k: Any         # [..., q, p] stabilizing feedback (zeros if unused)
    x_lo: Any      # [B, p] interval lower state
    x_hi: Any      # [B, p] interval upper state


def make_lpv(a0, da, x0, b=None, d=None, omega=None, k=None, device="cuda") -> LPV:
    """An LPV whose interval starts at the points ``x0`` (``[p]``, or ``[B, p]``
    for a batch of them)."""
    device = resolve_device(device)

    def f32(value):
        return torch.as_tensor(np.asarray(value, np.float32), device=device)

    a0 = f32(a0)
    p = a0.shape[0]
    da = f32(da).reshape(-1, p, p)
    b = f32(b) if b is not None else torch.zeros((p, 1), device=device)
    d = f32(d) if d is not None else torch.zeros((p, 1), device=device)
    if omega is None:
        omega_lo = omega_hi = torch.zeros(d.shape[1], device=device)
    else:
        # the reference's convention: omega's rows bound the perturbation
        omega = f32(omega).reshape(2, -1)
        omega_lo = torch.minimum(omega[0], omega[1])
        omega_hi = torch.maximum(omega[0], omega[1])
    k = f32(k) if k is not None else torch.zeros((b.shape[1], p), device=device)
    x0 = f32(x0).reshape(-1, p)
    return LPV(a0=a0, da=da, b=b, d=d, omega_lo=omega_lo, omega_hi=omega_hi,
               k=k, x_lo=x0, x_hi=x0)


def interval_matrices(lpv: LPV):
    """Elementwise interval [A_lo, A_hi] of A0 + sum_k alpha_k dA_k + B k."""
    p = lpv.b.shape[-2]
    if tuple(lpv.a0.shape[-2:]) != (p, p):
        # JAX's broadcasting error, for a polytope of another state size
        raise TypeError("add got incompatible shapes for broadcasting: "
                        f"{tuple(lpv.a0.shape)}, {(p, p)}")
    # ``a0 + b @ k``: a product over one control is a multiply, fused into the sum
    a_nom = lpv.a0
    for j in range(lpv.b.shape[-1]):
        a_nom = fma(lpv.b[..., :, j, None], lpv.k[..., j, None, :], a_nom)
    a_lo = a_nom + torch.clamp(lpv.da, max=0.0).sum(dim=-3)
    a_hi = a_nom + torch.clamp(lpv.da, min=0.0).sum(dim=-3)
    return a_lo, a_hi


def lpv_step(lpv: LPV, control, dt) -> LPV:
    """One Euler step of the interval predictor for every row of the batch;
    ``control`` is ``[B, q]`` (or ``[q]``, the same for every row)."""
    a_lo, a_hi = interval_matrices(lpv)
    xl, xh = lpv.x_lo, lpv.x_hi
    control = torch.as_tensor(control, dtype=torch.float32, device=xl.device)
    u = control.reshape(-1, lpv.b.shape[-1]).expand(xl.shape[0], -1)
    d_pos, d_neg = pos(lpv.d), neg(lpv.d)

    def derivative(t1, t2, t3, t4, w_pos, w_neg):
        dx = ((t1 - t2) - t3) + t4
        # the one-column products B u and D w are multiplies that XLA fuses
        # into the sum: one fused multiply-add each
        dx = matvec_add(dx, lpv.b, u)
        dx = matvec_add(dx, d_pos, w_pos.expand(xl.shape[0], -1))
        return matvec_add(dx, d_neg, w_neg.expand(xl.shape[0], -1), sign=-1.0)

    dxl = derivative(matvec(pos(a_lo), pos(xl)), matvec(pos(a_hi), neg(xl)),
                     matvec(neg(a_lo), pos(xh)), matvec(neg(a_hi), neg(xh)),
                     lpv.omega_lo, lpv.omega_hi)
    dxh = derivative(matvec(pos(a_hi), pos(xh)), matvec(pos(a_lo), neg(xh)),
                     matvec(neg(a_hi), pos(xl)), matvec(neg(a_lo), neg(xl)),
                     lpv.omega_hi, lpv.omega_lo)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=xl.device)
    # ``xl + dt * dxl`` is one fused multiply-add in XLA
    return lpv._replace(x_lo=fma(dt, dxl, xl), x_hi=fma(dt, dxh, xh))


def lpv_trajectory(lpv: LPV, controls, dt):
    """Run the predictor over ``controls`` (``[T, B, q]`` or ``[T, q]``);
    returns the stacked intervals ``(lo, hi)``, each ``[T, B, p]``."""
    lo, hi = [], []
    for u in controls:
        lpv = lpv_step(lpv, u, dt)
        lo.append(lpv.x_lo)
        hi.append(lpv.x_hi)
    return torch.stack(lo), torch.stack(hi)
