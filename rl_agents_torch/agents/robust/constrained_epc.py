"""Constrained EPC: bounded-noise estimation and stabilized interval control.

Port of ``rl_agents_tpu/agents/robust/constrained_epc.py`` (reference:
robust/constrained_epc.py:12-128): the confidence set is a bounded-noise
ellipsoid (constrained_epc.py:31-62), the nominal system is stabilized by a
feedback gain before interval prediction (constrained_epc.py:78-99), and the
model and the controller are synthesized again every ``update_frequency``
steps (constrained_epc.py:101-118) by an ``IntervalFeedbackAgent``.
"""
from __future__ import annotations

import itertools
import logging

import numpy as np

from rl_agents_torch.agents.control import IntervalFeedbackAgent
from rl_agents_torch.agents.robust.robust_epc import RobustEPCAgent

logger = logging.getLogger(__name__)


class ConstrainedEPCAgent(RobustEPCAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(env, config, device=device)
        self.feedback = IntervalFeedbackAgent(self.env, self.config, device=self.device)
        self.iteration = 0

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "noise_bound": 1,
            "perturbation_bound": 1,
            "update_frequency": 1,
            "K0": None, "K1": None, "K2": None, "S": None,
            "A0": [[0]], "dA": [[[0]]],
            "pole_placement": True,
            "ensure_stability": False,
            "control_bound": np.inf,
            "discrete": False,
        })
        return cfg

    def _box(self):
        return (np.array(self.config["parameter_box"][0], dtype=float),
                np.array(self.config["parameter_box"][1], dtype=float))

    def ellipsoid(self):
        """Bounded-noise confidence set (reference: constrained_epc.py:31-62)."""
        d = self.phi.shape[0]
        box_lo, box_hi = self._box()
        if not self.data:
            return (box_lo + box_hi) / 2, np.eye(d), np.sqrt(d) * self.config["parameter_bound"] / 2
        phi, y = self._regression_terms()
        g_n = np.sum([p.T @ p for p in phi], axis=0)
        try:
            g_n_inv = np.linalg.inv(g_n)
            theta_n = (g_n_inv @ np.sum(
                [phi[n].T @ y[n] for n in range(y.shape[0])], axis=0)).squeeze(axis=1)
            theta_n = theta_n.clip(box_lo, box_hi)
            beta_n = np.linalg.norm(g_n_inv) * sum(np.linalg.norm(p) for p in phi) \
                * self.config["noise_bound"]
        except np.linalg.LinAlgError:
            theta_n = (box_lo + box_hi) / 2
            g_n = np.eye(d)
            beta_n = np.sqrt(d) * self.config["parameter_bound"] / 2
        return theta_n, g_n, beta_n

    def polytope(self):
        """(reference: constrained_epc.py:64-76)"""
        theta_n, _, beta_n = self.ellipsoids[-1]
        d = theta_n.shape[0]
        box_lo, box_hi = self._box()
        h = np.array(list(itertools.product([-1, 1], repeat=d)))
        d_theta_k = np.clip([beta_n * h_k for h_k in h], -theta_n + box_lo, -theta_n + box_hi)
        a0 = self.A + np.tensordot(theta_n, self.phi, axes=[0, 0])
        da = [np.tensordot(d_theta, self.phi, axes=[0, 0]) for d_theta in d_theta_k]
        return a0, da

    def update_model_and_controller(self):
        """(reference: constrained_epc.py:101-109)"""
        a0, da = self.polytope()
        self.config.update({"A0": a0.tolist(), "dA": np.array(da).tolist(), "K0": None})
        self.feedback.update_config(self.config)
        self.feedback.reset()

    def act(self, observation):
        observation = dict(observation)
        observation.setdefault("interval_min", observation["state"])
        observation.setdefault("interval_max", observation["state"])
        if self.iteration < self.config["update_frequency"] \
                or self.iteration % self.config["update_frequency"] == 0:
            self.update_model_and_controller()
        return self.feedback.act(observation)

    def plan(self, observation):
        action = self.act(observation)
        self.iteration += 1
        return [action]

    def get_plan(self):
        return [0]
