"""Exploration policies: epsilon-greedy (exp-decay schedule), Boltzmann, greedy.

Port of ``rl_agents_tpu/agents/dqn/exploration.py`` (reference:
rl_agents/agents/common/exploration/). The JAX package runs these on the
host with numpy too; this copy keeps its draws, so one seed gives the same
actions in both packages. eps(t) = final + (init - final) * exp(-t / tau)
(epsilon_greedy.py:34-53).
"""
from __future__ import annotations

import numpy as np

from rl_agents_torch.configuration import Configurable


class DiscreteDistribution(Configurable):
    def __init__(self, config=None):
        super().__init__(config)
        self.np_random = np.random.default_rng()
        self.writer = None

    def get_distribution(self) -> dict:
        raise NotImplementedError

    def sample(self):
        distribution = self.get_distribution()
        return int(self.np_random.choice(list(distribution.keys()),
                                         p=np.array(list(distribution.values()))))

    def seed(self, seed=None):
        self.np_random = np.random.default_rng(seed)
        return [seed]

    def set_time(self, time):
        pass

    def step_time(self):
        pass

    def set_writer(self, writer):
        self.writer = writer

    def update(self, values):
        raise NotImplementedError


class Greedy(DiscreteDistribution):
    def __init__(self, num_actions: int, config=None):
        super().__init__(config)
        self.num_actions = num_actions
        self.values = None

    def get_distribution(self):
        optimal = int(np.argmax(self.values))
        return {a: 1.0 if a == optimal else 0.0 for a in range(self.num_actions)}

    def update(self, values):
        self.values = np.asarray(values)


class EpsilonGreedy(DiscreteDistribution):
    def __init__(self, num_actions: int, config=None):
        super().__init__(config)
        self.num_actions = num_actions
        self.config["final_temperature"] = min(self.config["temperature"],
                                               self.config["final_temperature"])
        self.optimal_action = 0
        self.epsilon = 0.0
        self.time = 0

    @classmethod
    def default_config(cls):
        return dict(temperature=1.0, final_temperature=0.1, tau=5000)

    def get_distribution(self):
        distribution = {a: self.epsilon / self.num_actions for a in range(self.num_actions)}
        distribution[self.optimal_action] += 1 - self.epsilon
        return distribution

    def update(self, values):
        self.optimal_action = int(np.argmax(values))
        self.epsilon = self.config["final_temperature"] + \
            (self.config["temperature"] - self.config["final_temperature"]) * \
            np.exp(-self.time / self.config["tau"])
        if self.writer:
            self.writer.add_scalar("exploration/epsilon", self.epsilon, self.time)

    def step_time(self):
        self.time += 1

    def set_time(self, time):
        self.time = time


class Boltzmann(DiscreteDistribution):
    def __init__(self, num_actions: int, config=None):
        super().__init__(config)
        self.num_actions = num_actions
        self.values = None

    @classmethod
    def default_config(cls):
        return dict(temperature=0.5)

    def get_distribution(self):
        if self.config["temperature"] > 0:
            v = np.asarray(self.values, dtype=np.float64)
            weights = np.exp((v - v.max()) / self.config["temperature"])
        else:
            weights = np.zeros(self.num_actions)
            weights[int(np.argmax(self.values))] = 1
        weights = weights / weights.sum()
        return {a: weights[a] for a in range(self.num_actions)}

    def update(self, values):
        self.values = np.asarray(values)


def exploration_factory(exploration_config: dict, action_space) -> DiscreteDistribution:
    """(reference: exploration/abstract.py:45-63)"""
    if hasattr(action_space, "spaces"):  # multi-agent tuple: per-ego set
        action_space = action_space.spaces[0]
    n = action_space.n if hasattr(action_space, "n") else int(action_space)
    method = exploration_config.get("method", "EpsilonGreedy")
    if method == "Greedy":
        return Greedy(n, exploration_config)
    elif method == "EpsilonGreedy":
        return EpsilonGreedy(n, exploration_config)
    elif method == "Boltzmann":
        return Boltzmann(n, exploration_config)
    raise ValueError(f"Unknown exploration method: {method}")
