"""Linear parametric-uncertainty control environments, batch-first.

Port of ``rl_agents_tpu/envs/linear.py``: the plants of the EPC agents and
the feedback controllers,

    dx/dt = A x + (phi x) theta + B u + D omega,   omega uniform in
    [-omega_bound, omega_bound],

with observations ``{"state", "derivative", "interval_min", "interval_max",
"reference_state"}`` (each ``[B, p]``), discrete actions as bang-bang
controls (``action_to_control``), reward ``max(0, 1 - x0^2)`` and
``info["constraint"]`` where ``|x0| > x_limit``. The uncertainty polytope
``(lpv_a0, lpv_da)`` lives in the params: the robust variant
(``robust_variant``) propagates the interval predictor of
``robust/interval.py`` alongside the state and takes the worst reward over
the interval's corners. Each step's draw of omega, uniform in [-1, 1) and
``[B, r]``, may be injected as ``noise``.

``LaneKeepingEnv`` is the lateral lane-keeping surrogate of highway-env's
``lane-keeping-v0`` (4 states ``[y, psi, vy, r]``, continuous steering).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Box, Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.robust.interval import LPV, lpv_step
from rl_agents_torch.utils.math import fma, fnma, matvec, matvec_add
from rl_agents_torch.utils.noise import NULL_KEY, noise_tensor, threefry_uniform


class LinearParams(NamedTuple):
    A: Any            # [p, p]
    B: Any            # [p, q]
    D: Any            # [p, r]
    phi: Any          # [d, p, p]
    theta: Any        # [d] true parameter
    omega_bound: Any  # [] noise bound
    dt: Any
    # the uncertainty polytope of the interval predictor (robust variant)
    lpv_a0: Any       # [p, p]
    lpv_da: Any       # [K, p, p]
    lpv_k: Any        # [q, p] stabilizing feedback
    omega_lo: Any     # [r]
    omega_hi: Any     # [r]


class LinearState(NamedTuple):
    x: Any     # [B, p]
    dx: Any    # [B, p]
    x_lo: Any  # [B, p] predictor interval
    x_hi: Any  # [B, p]
    t: Any     # [B] i64


def _params(A, B, D, phi, theta, dt, p, q, n_vertices, device) -> LinearParams:
    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return LinearParams(
        A=f32(A), B=f32(B), D=f32(D), phi=f32(phi), theta=f32(theta),
        omega_bound=f32(0.0), dt=f32(dt), lpv_a0=f32(np.zeros((p, p))),
        lpv_da=f32(np.zeros((n_vertices, p, p))), lpv_k=f32(np.zeros((q, p))),
        omega_lo=f32(np.zeros(1)), omega_hi=f32(np.zeros(1)))


def base_reward(x):
    """``clip(1 - x0^2, 0, 1)``: XLA fuses the square into the subtraction."""
    return torch.clamp(fnma(x[:, 0], x[:, 0], torch.ones_like(x[:, 0])), 0.0, 1.0)


class LinearSystemEnv(FunctionalEnv):
    def __init__(self, p: int = 2, q: int = 1, n_vertices: int = 2,
                 max_episode_steps: int = 100, x_limit: float = 2.0, robust: bool = False):
        self.p, self.q = p, q
        self.n_vertices = n_vertices
        self.max_episode_steps = max_episode_steps
        self.x_limit = x_limit
        self.robust = robust
        self.spec = EnvSpec("linear-system", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(2)

    @property
    def observation_space(self):
        return Box(-np.inf, np.inf, (self.p,))

    def default_params(self, device="cuda") -> LinearParams:
        # a double integrator with an uncertain damping: theta scales -x1
        return _params(A=[[0.0, 1.0], [0.0, 0.0]], B=[[0.0], [1.0]], D=[[0.0], [1.0]],
                       phi=[[[0.0, 0.0], [0.0, -1.0]]], theta=[0.5], dt=0.1,
                       p=self.p, q=self.q, n_vertices=self.n_vertices, device=device)

    def action_to_control(self, action):
        """``[B, q]`` controls of ``[B]`` discrete actions: bang-bang."""
        return (2.0 * action.to(torch.float32) - 1.0).reshape(-1, 1)

    def dynamics_matrix(self, params: LinearParams):
        """``A + theta . phi``: each parameter's product is fused into the sum."""
        a = params.A
        for i in range(params.theta.shape[0]):
            a = fma(params.theta[i].expand_as(a), params.phi[i], a)
        return a

    def initial_state(self, params):
        x0 = torch.zeros(self.p, device=params.A.device)
        x0[0] = -1.0
        return x0

    def reset(self, params, generator=None, batch: int = 1):
        x0 = self.initial_state(params).expand(batch, self.p).clone()
        state = LinearState(x=x0, dx=torch.zeros_like(x0), x_lo=x0, x_hi=x0,
                            t=torch.zeros(batch, dtype=torch.int64, device=x0.device))
        return state, self.observe(params, state)

    def observe(self, params, state: LinearState):
        return {"state": state.x, "derivative": state.dx, "interval_min": state.x_lo,
                "interval_max": state.x_hi, "reference_state": torch.zeros_like(state.x)}

    def _lpv(self, params: LinearParams, state: LinearState) -> LPV:
        return LPV(a0=params.lpv_a0, da=params.lpv_da, b=params.B, d=params.D,
                   omega_lo=params.omega_lo, omega_hi=params.omega_hi, k=params.lpv_k,
                   x_lo=state.x_lo, x_hi=state.x_hi)

    def null_noise(self, batch: int, device):
        """The omega draw under JAX's all-zero key (one perturbation, as
        both plants' ``D`` has one column)."""
        draw = threefry_uniform(NULL_KEY, (1,), -1.0, 1.0)
        return torch.tensor(draw, device=device).expand(batch, 1)

    def step(self, params: LinearParams, state: LinearState, action, generator=None,
             noise=None) -> StepOut:
        device = state.x.device
        batch = state.x.shape[0]
        u = self.action_to_control(action)
        r = params.D.shape[1]
        draw = noise_tensor(noise, device).reshape(batch, r) if noise is not None else \
            torch.rand((batch, r), generator=generator, device=generator.device).to(device) \
            * 2.0 - 1.0
        omega = params.omega_bound * draw
        # A x + B u + D omega: the one-column products are fused into the sum
        dx = matvec_add(matvec_add(matvec(self.dynamics_matrix(params), state.x),
                                   params.B, u), params.D, omega)
        x = fma(params.dt.expand_as(dx), dx, state.x)
        t = state.t + 1
        if self.robust:
            lpv = lpv_step(self._lpv(params, state), u, params.dt)
            new_state = LinearState(x=x, dx=dx, x_lo=lpv.x_lo, x_hi=lpv.x_hi, t=t)
            reward = torch.minimum(base_reward(lpv.x_lo), base_reward(lpv.x_hi))
            violated = torch.maximum(torch.abs(lpv.x_lo[:, 0]),
                                     torch.abs(lpv.x_hi[:, 0])) > self.x_limit
        else:
            new_state = LinearState(x=x, dx=dx, x_lo=x, x_hi=x, t=t)
            reward = base_reward(x)
            violated = torch.abs(x[:, 0]) > self.x_limit
        violated = violated.to(torch.float32)
        return StepOut(new_state, self.observe(params, new_state), reward,
                       torch.zeros(batch, dtype=torch.bool, device=device),
                       t >= self.max_episode_steps,
                       {"constraint": violated, "cost": violated})

    def robust_variant(self, n_vertices: int) -> "LinearSystemEnv":
        return LinearSystemEnv(self.p, self.q, n_vertices, self.max_episode_steps,
                               self.x_limit, robust=True)


def make(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = LinearSystemEnv(max_episode_steps=config.get("max_episode_steps", 100),
                          x_limit=config.get("x_limit", 2.0))
    params = env.default_params(device="cpu")
    if "theta" in config:
        params = params._replace(theta=torch.tensor(np.asarray(config["theta"], np.float32)))
    if "omega_bound" in config:
        params = params._replace(omega_bound=torch.tensor(np.float32(config["omega_bound"])))
    return EnvHandle(env, params, config, device=device)


class LaneKeepingEnv(LinearSystemEnv):
    """Lateral lane-keeping surrogate (highway-env lane-keeping-v0; reference:
    scripts/configs/LaneKeepingEnv/env.json): 4-state lateral bicycle
    dynamics x = [y, psi, vy, r] under continuous steering, the substrate of
    the LinearFeedback / ConstrainedEPC study. Controls are clipped to
    [-1, 1], not made bang-bang; the reward penalises lateral deviation."""

    @property
    def action_space(self):
        return Box(-1.0, 1.0, (self.q,))

    def action_to_control(self, action):
        action = action.reshape(action.shape[0], -1) if action.dim() > 0 else action.reshape(1, 1)
        return torch.clamp(action.to(torch.float32)[:, :self.q], -1.0, 1.0)

    def default_params(self, device="cuda") -> LinearParams:
        # constant speed (v = 10 m/s) linearised lateral dynamics with an
        # uncertain cornering-stiffness scale theta on the velocity states:
        # y' = v psi + vy; psi' = r; the vy and r rows from the tyre forces
        v = 10.0
        A = [[0.0, v, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, -4.0, -v],
             [0.0, 0.0, -1.0, -3.0]]
        phi = [[[0.0] * 4, [0.0] * 4, [0.0, 0.0, -1.0, 0.0], [0.0, 0.0, 0.0, -1.0]]]
        return _params(A=A, B=[[0.0], [0.0], [8.0], [4.0]], D=[[0.0], [0.0], [1.0], [1.0]],
                       phi=phi, theta=[0.5], dt=0.05, p=self.p, q=self.q,
                       n_vertices=self.n_vertices, device=device)

    def initial_state(self, params):
        x0 = torch.zeros(self.p, device=params.A.device)
        x0[0] = 0.5  # a 0.5 m lateral offset
        return x0


def make_lane_keeping(config: dict | None = None, device="cuda") -> EnvHandle:
    config = dict(config or {})
    env = LaneKeepingEnv(p=4, q=1, max_episode_steps=config.get("max_episode_steps", 200),
                         x_limit=config.get("x_limit", 4.0))
    return EnvHandle(env, None, config, device=device)
