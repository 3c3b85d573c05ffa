"""State samplers for value-function visualisation.

Port of ``rl_agents_tpu/trainer/state_sampler.py`` (reference:
trainer/state_sampler.py:5-77): hand-made state
meshes/lists per environment, used by ValueFunctionViewer.
"""
from __future__ import annotations

import numpy as np


class AbstractStateSampler:
    def states_list(self):
        raise NotImplementedError

    def states_mesh(self):
        raise NotImplementedError


class CartPoleStateSampler(AbstractStateSampler):
    """(reference: state_sampler.py:17-37)"""

    def __init__(self, resolution: int = 15):
        self.resolution = resolution

    def states_mesh(self):
        xx, yy = np.meshgrid(np.linspace(-1, 1, self.resolution),
                             np.linspace(-1, 1, self.resolution))
        xf, yf = np.reshape(xx, (-1, 1)), np.reshape(yy, (-1, 1))
        states = np.hstack((2 * xf, 2 * xf, np.pi / 6 * yf, np.pi / 6 * yf))
        return xx, yy, states

    def states_list(self):
        return np.array([[0, 0, 0, 0],
                         [-0.1, 0, 0, 0], [0.1, 0, 0, 0],
                         [0, 0, -0.1, 0], [0, 0, 0.1, 0]])


class MountainCarStateSampler(AbstractStateSampler):
    """(reference: state_sampler.py:40-56)"""

    def __init__(self, resolution: int = 15):
        self.resolution = resolution

    def states_mesh(self):
        xx, yy = np.meshgrid(np.linspace(-1, 1, self.resolution),
                             np.linspace(-1, 1, self.resolution))
        xf, yf = np.reshape(xx, (-1, 1)), np.reshape(yy, (-1, 1))
        states = np.hstack((-0.3 + 0.9 * xf, 0.07 * yf))
        return xx, yy, states

    def states_list(self):
        return np.array([[-0.5, 0], [-0.5, 0.04], [0.2, 0.04]])


class ObstacleStateSampler(AbstractStateSampler):
    """(reference: state_sampler.py:59-77)"""

    def __init__(self, resolution: int = 15):
        self.resolution = resolution

    def states_mesh(self):
        xx, yy = np.meshgrid(np.linspace(0, 1, self.resolution),
                             np.linspace(-1, 1, self.resolution))
        xf, yf = np.reshape(xx, (-1, 1)), np.reshape(yy, (-1, 1))
        states = np.hstack((xf, yf, np.zeros_like(xf), np.zeros_like(yf)))
        return xx, yy, states

    def states_list(self):
        return np.array([[0.5, 0, 0, 0], [0.5, -0.5, 0, 0], [0.5, 0.5, 0, 0]])
