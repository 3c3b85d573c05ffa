"""Value Iteration agent on finite MDPs.

Port of ``rl_agents_tpu/agents/dynamic_programming/value_iteration.py``
(reference: dynamic_programming/value_iteration.py:9-111): reads the
environment's MDP view, solves Q* with the Bellman fixed point
(``bellman.py``) on the agent's device, and acts greedily. An environment
exposes its model as ``env.mdp`` (the finite MDP and Sailing accessors) or
through ``to_finite_mdp()`` (highway's time-to-collision grid), which the
agent calls again at every ``act``, around the current state.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.agents.dynamic_programming.bellman import (
    BellmanModel,
    plan_trajectory,
    state_action_value,
)
from rl_agents_torch.utils.device import resolve_device


def mdp_view(env, device):
    """``(BellmanModel on device, mode, mdp)`` from an environment's MDP
    interface."""
    if getattr(env, "mdp", None) is not None:
        mdp = env.mdp
    elif hasattr(env, "unwrapped") and hasattr(env.unwrapped, "to_finite_mdp"):
        mdp = env.unwrapped.to_finite_mdp()
    elif hasattr(env, "to_finite_mdp"):
        mdp = env.to_finite_mdp()
    else:
        raise TypeError(
            "Environment must expose a finite MDP (env.mdp) or a to_finite_mdp() conversion")
    # next-state indices (deterministic) or probabilities (stochastic, sparse)
    transition = np.asarray(mdp.transition).astype(
        np.int64 if mdp.mode == "deterministic" else np.float32)
    model = BellmanModel(
        transition=torch.as_tensor(transition, device=device),
        reward=torch.as_tensor(np.asarray(mdp.reward, np.float32), device=device),
        terminal=torch.as_tensor(np.asarray(mdp.terminal, bool), device=device),
        next=torch.as_tensor(np.asarray(getattr(mdp, "next", 0), np.int64), device=device),
    )
    return model, mdp.mode, mdp


class ValueIterationAgent(AbstractAgent):
    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.model, self.mode, self.mdp = mdp_view(env, self.device)
        self.rederive_each_act = getattr(env, "mdp", None) is None
        self.state_action_value = self.get_state_action_value()

    @classmethod
    def default_config(cls):
        return dict(gamma=1.0, iterations=100)

    def get_state_value(self):
        return np.max(self.state_action_value, axis=-1)

    def get_state_action_value(self):
        return state_action_value(self.model, self.config["gamma"], self.mode,
                                  self.config["iterations"]).cpu().numpy()

    def act(self, state):
        if self.rederive_each_act:
            # non-finite envs re-derive the MDP around the current state
            # (reference: value_iteration.py:29-35)
            self.model, self.mode, self.mdp = mdp_view(self.env, self.device)
            state = self.mdp.state if hasattr(self.mdp, "state") else state
            self.state_action_value = self.get_state_action_value()
        if np.ndim(state) > 0 and hasattr(self.mdp, "state"):
            # a feature-vector observation: the MDP view tracks the index
            state = self.mdp.state
        return int(np.argmax(self.state_action_value[int(state), :]))

    def plan_trajectory(self, state, horizon: int = 10):
        states, actions = plan_trajectory(
            self.model, torch.as_tensor(self.state_action_value, device=self.device), state,
            self.mode, horizon)
        states = [int(s) for s in states.cpu().numpy() if s >= 0]
        actions = [int(a) for a in actions.cpu().numpy() if a >= 0]
        return states, actions

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        pass

    def seed(self, seed=None):
        pass
