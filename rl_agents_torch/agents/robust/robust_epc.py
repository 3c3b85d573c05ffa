"""Robust Estimation-Prediction-Control.

Port of ``rl_agents_tpu/agents/robust/robust_epc.py`` (reference:
robust/robust_epc.py:8-184):

* Estimation: regularised least squares over the recorded (x, u, dx) gives a
  confidence ellipsoid on the dynamics parameter theta (robust_epc.py:87-117);
* Prediction: the ellipsoid becomes a polytope (A0, {dA}) through the
  Gramian's eigendecomposition (robust_epc.py:119-132), and the planning env
  is forked into its robust variant with that polytope in its params, so
  that rewards are pessimistic over the interval predictor of
  ``robust/interval.py`` (robust_epc.py:134-150);
* Control: a sub-agent (OPD by default) plans on the robust fork.

The ellipsoid and the polytope are float64 numpy on the host, as in the JAX
package, so that the two packages give equal ones.
"""
from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.envs.base import EnvHandle
from rl_agents_torch.factory import load_agent
from rl_agents_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class RobustEPCAgent(AbstractAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self.A = np.array(self.config["A"], dtype=float)
        self.B = np.array(self.config["B"], dtype=float)
        self.phi = np.array(self.config["phi"], dtype=float)
        self.env = env
        self.data = []
        self.robust_env = None
        self.sub_agent = load_agent(self.config.get("sub_agent") or self.config["sub_agent_path"],
                                    env, device=self.device)
        self.ellipsoids = [self.ellipsoid()]

    @classmethod
    def default_config(cls):
        return {
            "gamma": 0.9,
            "delta": 0.9,
            "lambda": 1e-6,
            "sigma": [[1]],
            "A": [[1]],
            "B": [[1]],
            "D": [[1]],
            "omega": [[0], [0]],
            "phi": [[[1]]],
            "parameter_bound": 1,
            "parameter_box": [[0], [1]],
            "sub_agent": {"__class__": "DeterministicPlannerAgent", "budget": 40, "gamma": 0.9},
            "sub_agent_path": "",
        }

    # ------------------------------------------------------------------
    # Estimation (reference: robust_epc.py:44-117)
    # ------------------------------------------------------------------
    def record(self, observation, action, reward, next_observation, done, info):
        functional = getattr(self.env, "functional", None)
        if hasattr(functional, "action_to_control"):
            batch = torch.as_tensor(np.asarray(action))[None]
            control = functional.action_to_control(batch)[0].cpu().numpy()
        else:
            control = np.array([action], dtype=float)
        state = np.asarray(next_observation["state"], dtype=float)
        derivative = np.asarray(next_observation["derivative"], dtype=float)
        self.record_transition(state, derivative, control)

    def record_transition(self, state, derivative, control):
        self.data.append((state.reshape(-1, 1), np.asarray(control).reshape(-1, 1),
                          derivative.reshape(-1, 1)))
        self.ellipsoids.append(self.ellipsoid())

    def _regression_terms(self):
        """The regressors phi_n and the targets y_n = dx - A x - B u of the
        recorded transitions."""
        phi = np.array([np.squeeze(self.phi @ state, axis=2).transpose()
                        for state, _, _ in self.data])
        dx = np.array([derivative for _, _, derivative in self.data])
        ax = np.array([self.A @ state for state, _, _ in self.data])
        bu = np.array([self.B @ control for _, control, _ in self.data])
        return phi, dx - ax - bu

    def ellipsoid(self):
        """Sub-Gaussian confidence ellipsoid on theta (robust_epc.py:87-117)."""
        d = self.phi.shape[0]
        lambda_ = self.config["lambda"]
        if not self.data:
            g_n_lambda = lambda_ * np.identity(d)
            theta_n_lambda = np.zeros(d)
        else:
            phi, y = self._regression_terms()
            sigma_inv = np.linalg.inv(np.array(self.config["sigma"], dtype=float))
            g_n = np.sum([p.T @ sigma_inv @ p for p in phi], axis=0)
            g_n_lambda = g_n + lambda_ * np.identity(d)
            theta_n_lambda = (np.linalg.inv(g_n_lambda) @ np.sum(
                [phi[n].T @ sigma_inv @ y[n] for n in range(y.shape[0])], axis=0)
            ).squeeze(axis=1)
            theta_n_lambda = theta_n_lambda.clip(0, 1)
        beta_n = np.sqrt(2 * np.log(
            np.sqrt(np.linalg.det(g_n_lambda) / lambda_ ** d) / self.config["delta"])) \
            + np.sqrt(lambda_ * d) * self.config["parameter_bound"]
        return theta_n_lambda, g_n_lambda, beta_n

    # ------------------------------------------------------------------
    # Prediction (reference: robust_epc.py:119-150)
    # ------------------------------------------------------------------
    def polytope(self):
        theta_n_lambda, g_n_lambda, beta_n = self.ellipsoids[-1]
        d = g_n_lambda.shape[0]
        values, p = np.linalg.eig(g_n_lambda)
        m = beta_n * np.linalg.inv(p) @ np.diag(np.sqrt(1 / values))
        h = np.array(list(itertools.product([-1, 1], repeat=d)))
        d_theta_k = np.clip([m @ h_k for h_k in h],
                            -self.config["parameter_bound"], self.config["parameter_bound"])
        a0 = self.A + np.tensordot(theta_n_lambda, self.phi, axes=[0, 0])
        da = [np.tensordot(d_theta, self.phi, axes=[0, 0]) for d_theta in d_theta_k]
        return a0, da

    def robustify_env(self) -> EnvHandle:
        """A fork of the env handle in its robust variant, with the polytope
        and the perturbation bounds of the interval predictor in its params
        (on the handle's device)."""
        a0, da = self.polytope()
        da = np.real(np.array(da))
        robust_env = self.env.fork()
        robust_env.functional = self.env.functional.robust_variant(n_vertices=len(da))
        omega = np.array(self.config["omega"], dtype=float).reshape(2, -1)
        device = robust_env.device

        def f32(value):
            return torch.tensor(np.asarray(value, np.float32), device=device)

        robust_env.params = robust_env.params._replace(
            lpv_a0=f32(np.real(a0)), lpv_da=f32(da),
            omega_lo=f32(np.minimum(omega[0], omega[1])),
            omega_hi=f32(np.maximum(omega[0], omega[1])))
        return robust_env

    # ------------------------------------------------------------------
    # Control
    # ------------------------------------------------------------------
    def plan(self, observation):
        self.robust_env = self.robustify_env()
        self.sub_agent.env = self.robust_env
        return self.sub_agent.plan(observation)

    def act(self, state):
        return self.plan(state)[0]

    def get_plan(self):
        return self.sub_agent.previous_actions

    def reset(self):
        self.data = []
        self.ellipsoids = [self.ellipsoid()]
        return self.sub_agent.reset()

    def seed(self, seed=None):
        return self.sub_agent.seed(seed)


class NominalEPCAgent(RobustEPCAgent):
    """No model uncertainty in the prediction (reference: robust_epc.py:173-184)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(env, config, device=device)
        self.config["omega"] = np.zeros(np.shape(self.config["omega"])).tolist()

    def polytope(self):
        a0, _ = super().polytope()
        return a0, [np.zeros(a0.shape)]
