"""Tree-search shell: receding-horizon loop + budget allocation.

Port of ``rl_agents_tpu/agents/tree_search/common.py`` (reference:
tree_search/abstract.py:15-106): ``plan()`` handles the receding-horizon
counter and delegates the search itself to a planner, a batch-first tensor
program over fixed-capacity node arenas. The agent's randomness is one
``torch.Generator`` on the agent's device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.factory import preprocess_env
from rl_agents_torch.utils.device import resolve_device


def olop_horizon(episodes: int, gamma: float) -> int:
    """L(M, gamma) (reference: olop.py:42-44)."""
    return max(int(np.ceil(np.log(episodes) / (2 * np.log(1 / gamma)))), 1)


def allocation(budget: int, gamma: float):
    """Split a budget into M episodes x horizon L (reference: olop.py:50-62)."""
    for episodes in range(1, int(budget)):
        if episodes * olop_horizon(episodes, gamma) > budget:
            episodes = max(episodes - 1, 1)
            return episodes, olop_horizon(episodes, gamma)
    raise ValueError(f"Could not split budget {budget} with gamma {gamma}")


class AbstractTreeSearchAgent(AbstractAgent):
    """Receding-horizon planning loop (reference: tree_search/abstract.py:15-106)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.previous_actions: List[int] = []
        self.remaining_horizon = 0
        self.steps = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.last_plan_data = None  # planner outputs for introspection
        self.make_planner()

    @classmethod
    def default_config(cls):
        return {
            "budget": 500,
            "gamma": 0.8,
            "step_strategy": "reset",
            "env_preprocessors": [],
            "display_tree": False,
            "receding_horizon": 1,
            "terminal_reward": 0,
        }

    def make_planner(self):
        """Derive the planner's static sizes from this env/config."""
        raise NotImplementedError

    def planner_plan(self, env, observation) -> List[int]:
        """Run the planner on the (preprocessed) environment state."""
        raise NotImplementedError

    def plan(self, observation):
        self.steps += 1
        replanning_required = self.step(self.previous_actions)
        if replanning_required:
            # also honour the corpus's singular "env_preprocessor" spelling
            preprocessors = self.config["env_preprocessors"] \
                or self.config.get("env_preprocessor") or []
            env = preprocess_env(self.env, preprocessors)
            actions = self.planner_plan(env, observation)
        else:
            actions = self.previous_actions[1:]
        self.previous_actions = actions
        return actions

    def step(self, actions):
        """Receding-horizon counter (reference: abstract.py:70-82)."""
        replanning_required = self.remaining_horizon == 0 or len(actions) <= 1
        if replanning_required:
            self.remaining_horizon = self.config["receding_horizon"] - 1
        else:
            self.remaining_horizon -= 1
        return replanning_required

    def act(self, state):
        actions = self.plan(state)
        return actions[0]

    def reset(self):
        self.previous_actions = []
        self.remaining_horizon = 0
        self.steps = 0
        self.last_plan_data = None

    def seed(self, seed=None):
        if seed is not None:
            self.generator.manual_seed(seed)
        return [seed]

    def record(self, state, action, reward, next_state, done, info):
        pass

    def get_plan_list(self, actions, length) -> List[int]:
        actions = actions.cpu().numpy()
        length = int(length)
        return [int(a) for a in actions[:max(length, 1)]]
