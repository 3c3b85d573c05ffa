"""Robust Value Iteration over a finite ambiguity set of MDP models.

Port of ``rl_agents_tpu/agents/dynamic_programming/robust_value_iteration.py``
(reference: dynamic_programming/robust_value_iteration.py:6-73): the worst
case over M models is a minimum over a leading model axis, taken inside the
Bellman fixed point (``bellman.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.agents.dynamic_programming.bellman import (
    BellmanModel,
    robust_state_action_value,
)
from rl_agents_torch.utils.device import resolve_device


class RobustValueIterationAgent(AbstractAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.models_from_config()
        self.state_action_value = self.get_state_action_value()

    @classmethod
    def default_config(cls):
        return dict(gamma=1.0, iterations=100, models=[])

    def models_from_config(self):
        models = self.config.get("models")
        if not models:
            raise ValueError("No finite MDP model provided in agent configuration")
        self.mode = models[0]["mode"]
        transitions = np.array([m["transition"] for m in models])
        rewards = np.array([m["reward"] for m in models], dtype=np.float32)
        M, S, A = rewards.shape

        def _terminal(m):
            # the corpus spells per-state terminals as single-element rows
            # ([[0],[0],[1],[1]], FiniteMDPEnv/anti_vi): flatten, pad to [S]
            flat = np.asarray(m.get("terminal", np.zeros(S)), dtype=bool).reshape(-1)
            out = np.zeros(S, bool)
            out[:min(S, flat.shape[0])] = flat[:S]
            return out

        terminals = np.array([_terminal(m) for m in models], dtype=bool)
        transitions = transitions.astype(np.int64 if self.mode == "deterministic" else np.float32)
        self.models = BellmanModel(
            transition=torch.as_tensor(transitions, device=self.device),
            reward=torch.as_tensor(rewards, device=self.device),
            terminal=torch.as_tensor(terminals, device=self.device),
            next=torch.zeros((), dtype=torch.int64, device=self.device))

    def get_state_action_value(self):
        return robust_state_action_value(self.models, self.config["gamma"], self.mode,
                                         self.config["iterations"]).cpu().numpy()

    def get_state_value(self):
        return np.max(self.state_action_value, axis=-1)

    def act(self, state):
        return int(np.argmax(self.state_action_value[int(state), :]))

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        pass

    def seed(self, seed=None):
        pass
