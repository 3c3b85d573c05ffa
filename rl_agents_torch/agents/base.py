"""The universal agent interface.

Port of ``rl_agents_tpu/agents/base.py`` (reference:
rl_agents/agents/common/abstract.py:6-111): agents are policy objects driven
by a generic evaluation loop — ``act``/``plan`` out, ``record`` in — with a
seeding protocol, checkpoint hooks and writer wiring.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from rl_agents_torch.configuration import Configurable


class AbstractAgent(Configurable, ABC):
    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.writer = None
        self.directory = None

    @abstractmethod
    def record(self, state, action, reward, next_state, done, info):
        """Record a transition of the environment to update the agent."""
        raise NotImplementedError()

    @abstractmethod
    def act(self, state):
        """Pick an action for a given state."""
        raise NotImplementedError()

    def plan(self, state):
        """Plan an optimal trajectory; default = [act(state)]."""
        return [self.act(state)]

    @abstractmethod
    def reset(self):
        """Reset internal memory/state for a new episode."""
        raise NotImplementedError()

    @abstractmethod
    def seed(self, seed: Optional[int] = None):
        """Seed the agent's random streams."""
        raise NotImplementedError()

    def save(self, filename):
        """Save the model parameters to a file; False when stateless."""
        return False

    def load(self, filename):
        """Load the model parameters from a file; False when stateless."""
        return False

    def eval(self):
        """Set to testing mode (e.g. greedy exploration)."""
        pass

    def train(self):
        """Set to training mode."""
        pass

    def set_writer(self, writer):
        self.writer = writer

    def set_directory(self, directory):
        self.directory = directory

    def set_time(self, time):
        """Set a local time for schedules (exploration, etc.)."""
        pass


class AbstractStochasticAgent(AbstractAgent):
    """Agents exposing their full action distribution
    (reference: abstract.py:101-111; used as MCTS prior policies)."""

    def action_distribution(self, state):
        raise NotImplementedError()
