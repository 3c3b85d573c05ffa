"""Evaluation harness: the agent/environment test loop.

Port of the test loop of ``rl_agents_tpu/trainer/evaluation.py`` (reference:
rl_agents/trainer/evaluation.py:23-387): episode loop, the seeding protocol
(sim_seed + episode), run metadata, per-episode metrics. Each finished
episode is appended to ``episodes.jsonl`` in the run directory and, when
tensorboardX is installed, written as scalars.

Not ported yet: training, fused training, batched episodes, model recovery,
viewers and recorders.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from rl_agents_torch.configuration import serialize

logger = logging.getLogger(__name__)

_LOG_FORMAT = "[%(levelname)s] %(asctime)s %(name)s: %(message)s"


class NullWriter:
    """Metrics sink used when tensorboardX is not installed."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_histogram(self, *args, **kwargs):
        pass

    def close(self):
        pass


class Evaluation:
    OUTPUT_FOLDER = "out"
    RUN_FOLDER = "run_{}_{}"
    METADATA_FILE = "metadata.{}.json"
    LOGGING_FILE = "logging.{}.log"
    EPISODES_FILE = "episodes.jsonl"

    def __init__(self,
                 env,
                 agent,
                 directory=None,
                 num_episodes: int = 1000,
                 training: bool = False,
                 sim_seed: Optional[int] = None):
        if training:
            raise NotImplementedError("training is not yet ported to rl_agents_torch")
        self.env = env
        self.agent = agent
        self.num_episodes = num_episodes
        if sim_seed is None:
            sim_seed = int(np.random.default_rng().integers(0, 1_000_000))
        self.sim_seed = sim_seed

        self.directory = Path(directory or self.default_directory)
        self.run_directory = self.directory / self.default_run_directory
        self.run_directory.mkdir(parents=True, exist_ok=True)
        self.episode = 0
        self.writer = self._make_writer()
        self.agent.set_writer(self.writer)
        self.agent.set_directory(self.run_directory)
        self.agent.evaluation = self
        self._log_handler = self.write_logging()
        self.write_metadata()
        self.episode_rewards: List[float] = []
        self.observation = None

    def _make_writer(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return NullWriter()
        return SummaryWriter(str(self.run_directory))

    def test(self):
        self.agent.eval()
        self.run_episodes()
        self.close()

    def run_episodes(self):
        for self.episode in range(self.num_episodes):
            terminal = False
            self.reset(seed=self.episode)
            rewards = []
            start_time = time.time()
            while not terminal:
                reward, terminal = self.step()
                rewards.append(reward)
            self.after_all_episodes(self.episode, rewards, time.time() - start_time)

    def step(self):
        """plan -> env.step -> record (reference: evaluation.py:163-194)."""
        actions = self.agent.plan(self.observation)
        if actions is None or (hasattr(actions, "__len__") and len(actions) == 0):
            raise Exception("The agent did not plan any action")

        previous_observation, action = self.observation, actions[0]
        self.observation, reward, done, truncated, info = self.env.step(action)
        terminal = bool(done) or bool(truncated)
        try:
            self.agent.record(previous_observation, action, reward, self.observation, done, info)
        except NotImplementedError:
            pass
        return float(reward), terminal

    def after_all_episodes(self, episode: int, rewards: List[float], duration: float):
        rewards = np.array(rewards)
        gamma = self.agent.config.get("gamma", 1)
        total = float(np.sum(rewards))
        discounted = float(sum(r * gamma ** t for t, r in enumerate(rewards)))
        self.writer.add_scalar("episode/length", len(rewards), episode)
        self.writer.add_scalar("episode/total_reward", total, episode)
        self.writer.add_scalar("episode/return", discounted, episode)
        self.writer.add_scalar("episode/fps", len(rewards) / max(duration, 1e-6), episode)
        try:
            self.writer.add_histogram("episode/rewards", rewards, episode)
        except (AttributeError, ValueError):
            pass
        with (self.run_directory / self.EPISODES_FILE).open("a") as f:
            f.write(json.dumps({"episode": episode, "length": len(rewards),
                                "total_reward": total, "return": discounted,
                                "duration": duration}) + "\n")
        self.episode_rewards.append(total)
        logger.info("Episode %d score: %.1f", episode, total)

    @property
    def default_directory(self) -> Path:
        spec = getattr(self.env, "spec", None)
        if spec is not None and getattr(spec, "id", None):
            env_name = spec.id
        else:
            env_name = type(getattr(self.env, "unwrapped", self.env)).__name__
        return Path(self.OUTPUT_FOLDER) / env_name / self.agent.__class__.__name__

    @property
    def default_run_directory(self) -> str:
        return self.RUN_FOLDER.format(datetime.datetime.now().strftime("%Y%m%d-%H%M%S"), os.getpid())

    def write_metadata(self):
        metadata = dict(env=serialize(self.env), agent=serialize(self.agent))
        file_infix = f"{id(self.env)}.{os.getpid()}"
        file = self.run_directory / self.METADATA_FILE.format(file_infix)
        with file.open("w") as f:
            json.dump(metadata, f, sort_keys=True, indent=4, default=repr)

    def write_logging(self) -> logging.Handler:
        file_infix = f"{id(self.env)}.{os.getpid()}"
        handler = logging.FileHandler(self.run_directory / self.LOGGING_FILE.format(file_infix))
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        logging.getLogger().addHandler(handler)
        return handler

    def reset(self, seed: int = 0):
        """Seeding protocol (reference: evaluation.py:372-376): env reset with
        the episode seed; agent seeded with sim_seed + episode."""
        seed = self.sim_seed + seed
        self.observation, _ = self.env.reset(seed=seed)
        self.agent.seed(seed)
        self.agent.reset()

    def close(self):
        self.writer.close()
        logging.getLogger().removeHandler(self._log_handler)
        self._log_handler.close()
        self.env.close()
