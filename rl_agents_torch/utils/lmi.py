"""LMI feasibility by convex spectral-penalty descent.

Port of ``rl_agents_tpu/utils/lmi.py``, which replaces the reference's
cvxpy/SCS semidefinite solves (reference: control/interval_feedback.py:118-226)
with a dependency-free solver. The feasibility problem

    find vars   s.t.   M(vars) <= 0   (M affine, symmetric),
                       g_i(vars) >= eps   (g_i concave, elementwise)

is solved by minimising the convex penalty

    relu(lmax_tau(M(vars)) + delta) + sum_i relu(eps - g_i(vars))

where ``lmax_tau`` is the tau-smoothed largest eigenvalue (tau times the
logsumexp of spectrum / tau: convex, differentiable, an upper bound on
lambda_max). The descent is ADAM (``models/optimizers.py``, optax's rule)
with gradients from autograd through ``torch.linalg.eigvalsh``, in chunks of
``check_every`` steps with the moments carried across chunks. After each
chunk the candidate is checked against the ORIGINAL constraints by an exact
float64 ``eigvalsh`` on the host: the solver can fail to certify, it cannot
falsely certify.

A problem is two functions of a dict of float32 tensors on one device:
``matrix(theta) -> M`` and ``constraints(theta) -> [g_i, ...]``. Because M is
affine, the descent evaluates it once at 0 and once at each unit vector of
the flattened variables, and then computes it as one product
``offset + x @ basis`` a step, in place of building it block by block.
``eigvalsh`` on the card reads its status back to the host once a call, so
no CUDA graph can hold a chunk of steps.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rl_agents_torch.models.optimizers import apply_updates, optimizer_factory
from rl_agents_torch.utils.device import resolve_device


class AffineMatrix(NamedTuple):
    """``M(theta) = offset + sum_v x_v basis_v`` over the variables of
    ``theta`` flattened in the order of ``names``."""

    offset: torch.Tensor  # [m, m]
    basis: torch.Tensor   # [V, m * m]
    names: tuple
    shapes: tuple


def affine_matrix(matrix: Callable, theta0: Dict[str, torch.Tensor]) -> AffineMatrix:
    """The affine map of ``matrix`` from its value at 0 and at each unit vector."""
    names = tuple(sorted(theta0))
    shapes = tuple(tuple(theta0[k].shape) for k in names)
    total = sum(int(np.prod(shape)) for shape in shapes)
    like = theta0[names[0]]
    layout = AffineMatrix(None, None, names, shapes)
    offset = matrix(unflatten(layout, torch.zeros(total, dtype=like.dtype, device=like.device)))
    unit = torch.eye(total, dtype=like.dtype, device=like.device)
    basis = torch.stack([matrix(unflatten(layout, unit[v])) - offset for v in range(total)])
    return AffineMatrix(offset, basis.reshape(total, -1), names, shapes)


def flatten(layout: AffineMatrix, theta: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([theta[k].reshape(-1) for k in layout.names])


def unflatten(layout: AffineMatrix, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, start = {}, 0
    for name, shape in zip(layout.names, layout.shapes):
        size = int(np.prod(shape))
        out[name] = x[start:start + size].reshape(shape)
        start += size
    return out


def _lmax_smooth(M, tau: float):
    w = torch.linalg.eigvalsh(M)
    return tau * torch.logsumexp(w / tau, dim=-1)


def spectral_penalty(affine: AffineMatrix, constraints: Callable, x: torch.Tensor, tau: float,
                     delta: float, eps: float) -> torch.Tensor:
    """The penalty at the flattened variables ``x``: its minimum is 0 exactly
    where the delta-tightened problem is feasible."""
    m = affine.offset.shape[-1]
    M = affine.offset + (x @ affine.basis).reshape(m, m)
    M = 0.5 * (M + M.T)
    g = torch.cat([c.reshape(-1) for c in constraints(unflatten(affine, x))])
    return F.relu(_lmax_smooth(M, tau) + delta) + torch.sum(F.relu(eps - g))


def penalty_and_grad(affine: AffineMatrix, constraints: Callable, x: torch.Tensor, tau: float,
                     delta: float, eps: float):
    """The penalty at ``x`` and its gradient."""
    x = x.detach().requires_grad_(True)
    loss = spectral_penalty(affine, constraints, x, tau, delta, eps)
    return loss.detach(), torch.autograd.grad(loss, x)[0]


def _certify(matrix: Callable, constraints: Callable, theta, eps: float, tol: float) -> bool:
    """Exact verification of the ORIGINAL constraints in float64 on the host
    (never falsely certifies)."""
    M = np.asarray(matrix(theta).detach().cpu().numpy(), np.float64)
    M = 0.5 * (M + M.T)
    lmax = float(np.max(np.linalg.eigvalsh(M)))
    return lmax <= tol and all(float(np.min(g.detach().cpu().numpy())) >= 0.5 * eps
                               for g in constraints(theta))


def solve_spectral_feasibility(matrix: Callable, constraints: Callable,
                               theta0: Dict[str, torch.Tensor], iters: int = 8000,
                               lr: float = 0.02, tau: float = 1e-2, delta: float = 1e-3,
                               eps: float = 1e-6, tol: float = 0.0, check_every: int = 1000):
    """Solve ``matrix(theta) <= 0, constraints(theta) >= eps`` for the dict
    ``theta``. Returns ``(theta as numpy arrays, certified)``. The descent
    runs in ``check_every``-step chunks (the ADAM state carried across them,
    so the trajectory is one long run) with the exact certification after
    each: a well-conditioned feasible system certifies after one or two
    chunks. ``solve_spectral_feasibility.steps`` counts the descent steps of
    the last solve."""
    affine = affine_matrix(matrix, theta0)
    opt = optimizer_factory("ADAM", lr=lr)
    x = flatten(affine, theta0).detach().clone()
    opt_state = opt.init([x])
    done, certified = 0, False
    while done < iters:
        chunk = min(check_every, iters - done)
        for _ in range(chunk):
            _, grad = penalty_and_grad(affine, constraints, x, tau, delta, eps)
            updates, opt_state = opt.update([grad], opt_state, [x])
            x = apply_updates([x], updates)[0]
        done += chunk
        if _certify(matrix, constraints, unflatten(affine, x), eps, tol):
            certified = True
            break
    solve_spectral_feasibility.steps = done
    return {k: v.detach().cpu().numpy() for k, v in unflatten(affine, x).items()}, certified


solve_spectral_feasibility.steps = 0

# ---------------------------------------------------------------------------
# Interval-feedback stability/synthesis LMIs (reference:
# control/interval_feedback.py:118-226). Variables P, Q, Qp, Qn, Zp, Zn, Psi,
# Psi_p, Psi_n, Gamma are diagonal (stored as vectors); U0, U1, U2 are full
# q x 2p gain pre-images. In synthesis mode P/Zp/Zn stand for their inverses
# and the gains are K0 = U0 P^-1, K1 = U1 Zp^-1, K2 = U2 Zn^-1.
# ---------------------------------------------------------------------------

DIAG_VARS = ("P", "Q", "Qp", "Qn", "Zp", "Zn", "Psi", "Psi_p", "Psi_n", "Gamma")


def interval_lmi_matrix(theta, cA0, cA1, cA2, cB, synthesize: bool):
    P, Q, Qp, Qn = theta["P"], theta["Q"], theta["Qp"], theta["Qn"]
    Zp, Zn, Psi = theta["Zp"], theta["Zn"], theta["Psi"]
    Psi_p, Psi_n, Gamma = theta["Psi_p"], theta["Psi_n"], theta["Gamma"]
    n = cA0.shape[0]
    Id = torch.eye(n, device=cA0.device)
    diag = torch.diag
    if synthesize:
        U0, U1, U2 = theta["U0"], theta["U1"], theta["U2"]
        # diag(v) @ A == v[:, None] * A;  A @ diag(v) == A * v[None, :]
        Pi_11 = P[:, None] * cA0.T + cA0 * P[None, :] + U0.T @ cB.T + cB @ U0 + diag(Q)
        Pi_12 = cA1 * Zp[None, :] + cB @ U1 + P[:, None] * cA0.T + U0.T @ cB.T + diag(Psi_p)
        Pi_13 = cA2 * Zn[None, :] + cB @ U2 - P[:, None] * cA0.T - U0.T @ cB.T - diag(Psi_n)
        Pi_22 = Zp[:, None] * cA1.T + cA1 * Zp[None, :] + U1.T @ cB.T + cB @ U1 + diag(Qp)
        Pi_23 = cA2 * Zn[None, :] + cB @ U2 - Zp[:, None] * cA1.T - U1.T @ cB.T + diag(Psi)
        Pi_33 = diag(Qn) - Zn[:, None] * cA2.T - cA2 * Zn[None, :] - U2.T @ cB.T - cB @ U2
        return torch.cat([
            torch.cat([Pi_11, Pi_12, Pi_13, Id], dim=1),
            torch.cat([Pi_12.T, Pi_22, Pi_23, Id], dim=1),
            torch.cat([Pi_13.T, Pi_23.T, Pi_33, -Id], dim=1),
            torch.cat([Id, Id, -Id, -diag(Gamma)], dim=1)], dim=0)
    Ups_11 = cA0.T * P[None, :] + P[:, None] * cA0 + diag(Q)
    Ups_12 = cA0.T * Zp[None, :] + P[:, None] * cA1 + diag(Psi_p)
    Ups_13 = P[:, None] * cA2 - cA0.T * Zn[None, :] - diag(Psi_n)
    Ups_22 = Zp[:, None] * cA1 + cA1.T * Zp[None, :] + diag(Qp)
    Ups_23 = Zp[:, None] * cA2 - cA1.T * Zn[None, :] + diag(Psi)
    Ups_33 = diag(Qn) - Zn[:, None] * cA2 - cA2.T * Zn[None, :]
    return torch.cat([
        torch.cat([Ups_11, Ups_12, Ups_13, diag(P)], dim=1),
        torch.cat([Ups_12.T, Ups_22, Ups_23, diag(Zp)], dim=1),
        torch.cat([Ups_13.T, Ups_23.T, Ups_33, -diag(Zn)], dim=1),
        torch.cat([diag(P), diag(Zp), -diag(Zn), -diag(Gamma)], dim=1)], dim=0)


def interval_lmi_problem(cA0, cA1, cA2, cB, synthesize_control: bool = True, device="cuda"):
    """The interval LMI as ``(matrix, constraints, theta0)`` on ``device``:
    ``theta0`` sets every diagonal variable to 1 and the gain pre-images to 0."""
    device = resolve_device(device)

    def f32(m):
        return torch.as_tensor(np.asarray(m, np.float32), device=device)

    cA0, cA1, cA2, cB = f32(cA0), f32(cA1), f32(cA2), f32(cB)
    n, q = cA0.shape[0], cB.shape[1]
    theta0 = {name: torch.ones(n, device=device) for name in DIAG_VARS}
    if synthesize_control:
        theta0.update({f"U{i}": torch.zeros((q, n), device=device) for i in range(3)})

    def matrix(theta):
        return interval_lmi_matrix(theta, cA0, cA1, cA2, cB, synthesize_control)

    def constraints(theta):
        Omega = theta["Q"] + torch.minimum(theta["Qp"], theta["Qn"]) \
            + 2 * torch.minimum(theta["Psi_p"], theta["Psi_n"])
        if synthesize_control:
            return [theta["P"], theta["Zp"], theta["Zn"], theta["Gamma"], Omega]
        return [theta["P"], theta["P"] + torch.minimum(theta["Zp"], theta["Zn"]),
                theta["Gamma"], Omega]

    return matrix, constraints, theta0


def solve_interval_lmi(cA0, cA1, cA2, cB, synthesize_control: bool = True,
                       epsilon: float = 1e-6, iters: int = 8000, device="cuda"):
    """Feasibility of the interval-observer stability LMI; optionally
    synthesize the (K0, K1, K2) interval-feedback gains.

    Returns a dict of numpy matrices: the diagonal P/Zp/Zn/Gamma/Omega
    (inverted back in synthesis mode, as the reference recovers them at
    interval_feedback.py:210-222) and the gains K0/K1/K2 when synthesizing;
    or None when feasibility could not be certified."""
    matrix, constraints, theta0 = interval_lmi_problem(cA0, cA1, cA2, cB, synthesize_control,
                                                       device=device)
    theta, ok = solve_spectral_feasibility(matrix, constraints, theta0, iters=iters, eps=epsilon)
    if not ok:
        return None
    out = {key: np.diag(theta[key]) for key in ("P", "Zp", "Zn", "Gamma")}
    out["Omega"] = np.diag(theta["Q"] + np.minimum(theta["Qp"], theta["Qn"])
                           + 2 * np.minimum(theta["Psi_p"], theta["Psi_n"]))
    if synthesize_control:
        # P/Zp/Zn were the inverses (reference: interval_feedback.py:151-153)
        P, Zp, Zn = (np.linalg.inv(out[k]) for k in ("P", "Zp", "Zn"))
        out.update(P=P, Zp=Zp, Zn=Zn,
                   K0=theta["U0"] @ P, K1=theta["U1"] @ Zp, K2=theta["U2"] @ Zn)
    return out
