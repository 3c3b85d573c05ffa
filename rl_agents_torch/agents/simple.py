"""Simple baseline agents.

Port of ``rl_agents_tpu/agents/simple.py`` (reference: rl_agents/agents/simple/):
``RandomUniformAgent`` draws its actions as the JAX package's agent does,
from the threefry key ``PRNGKey(seed)`` split once per ``act``, replayed on
the host by ``utils/noise.py``; ``OpenLoopAgent`` replays a configured
action sequence.
"""
from __future__ import annotations

import numpy as np

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.envs.base import Box, Discrete
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.noise import (
    prng_key,
    threefry_randint,
    threefry_split,
    threefry_uniform,
)


class RandomUniformAgent(AbstractAgent):
    """Uniformly random actions (reference: simple/random.py)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.key = prng_key(0)

    def act(self, state):
        self.key, sub = threefry_split(self.key, 2)
        space = self.env.action_space
        if isinstance(space, Discrete):
            return threefry_randint(sub, space.n)
        if isinstance(space, Box):
            # infinite bounds are clipped to +-1e3, as the JAX package's Box.sample does
            low = np.nan_to_num(np.asarray(space.low, np.float32), neginf=-1e3)
            high = np.nan_to_num(np.asarray(space.high, np.float32), posinf=1e3)
            return threefry_uniform(sub, tuple(space.shape), low, high)
        raise TypeError(f"RandomUniformAgent cannot sample {type(space).__name__}")

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        pass

    def seed(self, seed=None):
        if seed is not None:
            self.key = prng_key(seed)
        return [seed]


class OpenLoopAgent(AbstractAgent):
    """Replays a configured action sequence (reference: simple/open_loop.py)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.t = 0

    @classmethod
    def default_config(cls):
        return dict(actions=[0])

    def act(self, state):
        actions = self.config["actions"]
        action = actions[min(self.t, len(actions) - 1)]
        self.t += 1
        return action

    def plan(self, state):
        return self.config["actions"][self.t:] or [self.config["actions"][-1]]

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        self.t = 0

    def seed(self, seed=None):
        return [seed]

    def set_time(self, time):
        self.t = time
