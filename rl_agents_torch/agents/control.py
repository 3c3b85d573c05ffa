"""Feedback controllers: linear state feedback and interval feedback.

Port of ``rl_agents_tpu/agents/control.py``:

* LinearFeedbackAgent (reference: control/linear_feedback.py:5-45):
  u = K (x_ref - x), optionally discretised to a bang-bang action.
* IntervalFeedbackAgent (reference: control/interval_feedback.py:10-265):
  control from interval observations u = K0 xi + K1 xi+ + K2 xi- + S delta.
  The gains are synthesized by the interval LMI, solved by the spectral-penalty
  descent of ``utils/lmi.py`` on the agent's device in place of the
  reference's cvxpy/SCS, with pole placement (host scipy, the reference's
  own fallback, interval_feedback.py:96-109) when it cannot certify or when
  configured; S = -pinv(cB) minimises ||cB S + I|| in closed form
  (interval_feedback.py:245-265).

The control law and the synthesis bookkeeping are host numpy, as in the JAX
package: a control is a handful of products of matrices of size 2p.
"""
from __future__ import annotations

import logging

import numpy as np

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.lmi import solve_interval_lmi

logger = logging.getLogger(__name__)


def _pos(x):
    return np.maximum(x, 0)


def _neg(x):
    return np.maximum(-x, 0)


def extended_matrices(A0, dA, B):
    """The interval system's matrices (cA0, cA1, cA2, cB) of a polytope
    (A0, {dA_i}) with control matrix B (reference: interval_feedback.py:85-93)."""
    A0, dA, B = (np.array(m, dtype=float) for m in (A0, dA, B))
    dAp = sum(_pos(dAi) for dAi in dA)
    dAn = sum(_neg(dAi) for dAi in dA)
    p = int(B.shape[0])
    zero = np.zeros((p, p))
    cA0 = np.block([[A0, zero], [zero, A0]])
    cA1 = np.block([[zero, -dAn], [zero, dAp]])
    cA2 = np.block([[-dAp, zero], [dAn, zero]])
    return cA0, cA1, cA2, np.concatenate((B, B))


class LinearFeedbackAgent(AbstractAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self.K = np.array(self.config["K"], dtype=float)
        self.env = env

    @classmethod
    def default_config(cls):
        return {"K": [[0]], "discrete": False}

    def act(self, observation):
        if isinstance(observation, dict):
            state = np.asarray(observation["state"], dtype=float)
            reference = np.asarray(observation["reference_state"], dtype=float)
        else:
            state = np.asarray(observation, dtype=float)
            reference = np.zeros(state.shape)
        control = self.K @ (reference - state)
        if self.config["discrete"]:
            return 1 if float(np.ravel(control)[0]) < 0 else 0
        return np.asarray(control).reshape(-1)

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        pass

    def seed(self, seed=None):
        return [seed]


class IntervalFeedbackAgent(LinearFeedbackAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(env, config, device=device)
        self.K0 = self._matrix("K0")
        self.K1 = self._matrix("K1")
        self.K2 = self._matrix("K2")
        self.S = self._matrix("S")
        self.D = np.array(self.config["D"], dtype=float)
        self.Xf = None

    def _matrix(self, key):
        return None if self.config.get(key) is None else np.array(self.config[key])

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "K0": None, "K1": None, "K2": None, "S": None,
            "A0": [[0]], "dA": [[[0]]], "B": [[1]], "D": [[1]],
            "discrete": False,
            "pole_placement": False,
            "ensure_stability": True,
            "control_bound": np.inf,
            "perturbation_bound": 1,
        })
        return cfg

    def update_config(self, config):
        self.config.update(config)
        self.K0 = self._matrix("K0")

    def reset(self):
        if self.S is None:
            self.synthesize_perturbation_rejection()
        if self.K0 is None:
            self.synthesize_controller(self.config["pole_placement"],
                                       self.config["ensure_stability"])

    # ------------------------------------------------------------------
    # Control law (reference: interval_feedback.py:45-64)
    # ------------------------------------------------------------------
    def act(self, observation):
        if not isinstance(observation, dict):
            raise ValueError("The observation should be a dict containing the interval bounds")
        x_m = np.asarray(observation["interval_min"], dtype=float).reshape(-1)
        x_M = np.asarray(observation["interval_max"], dtype=float).reshape(-1)
        x_ref = np.asarray(observation["reference_state"], dtype=float).reshape(-1)
        xi = np.concatenate((x_m - x_ref, x_M - x_ref))
        control = self.K0 @ xi + self.K1 @ _pos(xi) + self.K2 @ _neg(xi) \
            + (self.S @ self.delta()).reshape(-1)
        control = np.clip(control, -self.config["control_bound"], self.config["control_bound"])
        if self.config["discrete"]:
            return 1 if float(np.ravel(control)[0]) < 0 else 0
        return np.asarray(control).reshape(-1)

    def delta(self):
        """Extended perturbation interval (reference: interval_feedback.py:57-64)."""
        omega_m = np.array([[self.config["perturbation_bound"]]], dtype=float)
        omega_M = np.array([[-self.config["perturbation_bound"]]], dtype=float)
        cD = np.concatenate((np.concatenate((_pos(self.D), -_neg(self.D)), axis=1),
                             np.concatenate((-_neg(self.D), _pos(self.D)), axis=1)))
        return cD @ np.concatenate((omega_m, omega_M))

    # ------------------------------------------------------------------
    # Synthesis
    # ------------------------------------------------------------------
    def synthesize_controller(self, pole_placement: bool = False,
                              ensure_stability: bool = True) -> bool:
        """(reference: interval_feedback.py:66-116) Build the interval system's
        matrices, then synthesize the gains with the stability LMI, or check
        a pole-placed gain with the analysis LMI."""
        A0 = np.array(self.config["A0"], dtype=float)
        B = np.array(self.config["B"], dtype=float)
        p = int(B.shape[0])
        cA0, cA1, cA2, cB = extended_matrices(A0, self.config["dA"], B)
        if pole_placement:
            K = self._pole_placement_gain(A0, B, p)
            self.K0 = 0.5 * np.concatenate((K, K), axis=1)
            self.K1 = np.zeros(self.K0.shape)
            self.K2 = np.zeros(self.K0.shape)
            cA0 = cA0 + cB @ self.K0
            if not ensure_stability:
                return True
        success = self._stability_lmi(cA0, cA1, cA2, cB, synthesize_control=not pole_placement)
        if not success and not pole_placement:
            # (reference: interval_feedback.py:113-116)
            success = self.synthesize_controller(pole_placement=True,
                                                 ensure_stability=ensure_stability)
        return success

    def _pole_placement_gain(self, A0, B, p):
        """(reference fallback: interval_feedback.py:96-109)"""
        from scipy.signal import place_poles

        eigs = np.real(np.linalg.eigvals(A0))
        poles = self.config.get("poles", np.minimum(eigs, -np.arange(1, p + 1, dtype=float)))
        poles = np.unique(np.asarray(poles, dtype=float) - 1e-3 * np.arange(len(poles)))
        while len(poles) < p:
            poles = np.append(poles, poles.min() - 1.0)
        return -place_poles(A0, B, poles[:p]).gain_matrix

    def _stability_lmi(self, cA0, cA1, cA2, cB, synthesize_control: bool = True) -> bool:
        """Stability/synthesis LMI (reference: interval_feedback.py:118-226)
        by spectral-penalty descent on the agent's device. In synthesis mode
        the gains (K0, K1, K2) are recovered from the solution; in analysis
        mode the LMI certifies the pole-placed closed loop."""
        sol = solve_interval_lmi(cA0, cA1, cA2, cB, synthesize_control=synthesize_control,
                                 device=self.device)
        if sol is None:
            logger.debug("stability LMI: infeasible / not certified")
            return False
        if synthesize_control:
            self.K0, self.K1, self.K2 = sol["K0"], sol["K1"], sol["K2"]
        self.compute_attraction_basin(cB, sol["Gamma"], sol["Omega"], sol["P"], sol["Zp"],
                                      sol["Zn"])
        return True

    def compute_attraction_basin(self, cB, Gamma, Omega, P, Zp, Zn):
        """The interval that asymptotically contains xi under the certified
        closed loop (reference: interval_feedback.py:228-243)."""
        Id = np.eye(Gamma.shape[0])
        delta_tilde = (cB @ self.S + Id) @ self.delta()
        alpha = np.amin(np.real(np.linalg.eigvals(Omega @ np.linalg.inv(P + _pos(Zp) + _pos(Zn)))))
        v_max = np.abs(delta_tilde.T @ Gamma @ delta_tilde) / max(alpha, 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.Xf = 1 / np.sqrt(np.diagonal(P / np.maximum(v_max, 1e-12)))

    def synthesize_perturbation_rejection(self):
        """min_S ||cB S + I||_2 in closed form, S = -pinv(cB) (in place of the
        reference's norm-min SDP, interval_feedback.py:245-265): cB = [B; B]
        is tall, so for any unit u in ker(cB^T), ||(cB S + I)^T u|| = 1 bounds
        the norm below by 1, and the projector I - cB pinv(cB) attains it."""
        B = np.array(self.config["B"], dtype=float)
        self.S = -np.linalg.pinv(np.concatenate((B, B)))
