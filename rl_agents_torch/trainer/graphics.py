"""Live reward viewer.

Port of ``rl_agents_tpu/trainer/graphics.py`` (reference:
rl_agents/trainer/graphics.py:8-28): the total reward of each episode and its
running mean over 30 episodes, redrawn after every episode; nothing is drawn
where matplotlib is not installed.
"""
from __future__ import annotations

import numpy as np


class RewardViewer:
    def __init__(self):
        self.rewards = []

    def update(self, reward: float):
        self.rewards.append(reward)
        self.display()

    def mean_curve(self) -> np.ndarray:
        """The running mean the viewer draws beside the rewards."""
        return np.convolve(self.rewards, np.ones(min(len(self.rewards), 30)) / 30, mode="valid")

    def display(self):
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.figure(num="Rewards")
        plt.clf()
        plt.title("Total reward")
        plt.xlabel("Episode")
        plt.ylabel("Reward")
        plt.plot(self.rewards)
        means = self.mean_curve()
        plt.plot(np.arange(len(means)), means)
        plt.pause(0.001)
