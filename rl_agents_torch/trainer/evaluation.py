"""Evaluation harness: the agent/environment train and test loops.

Port of ``rl_agents_tpu/trainer/evaluation.py`` (reference:
rl_agents/trainer/evaluation.py:23-387): train/test episode loops (plan ->
env.step -> ``record``), the seeding protocol (sim_seed + episode), run
metadata, per-episode metrics, the checkpoint cadence (cubic schedule and the
best-EMA window, ``saved_models/latest.tar``, ``checkpoint-final`` on close),
model recovery, whole-run fused training for agents with ``"fused": true``,
and the batched episodes of the fitted agents (``agent.batched``: FTQ, BFTQ),
which alternate sample collection and ``update()``. Each finished episode is
appended to ``episodes.jsonl`` in the run directory and, when tensorboardX
is installed, written as scalars (``trainer/metrics.py::NullWriter``
otherwise).

Not ported yet: the viewers and recorders (``display_env``,
``display_agent``, ``display_rewards``), which wait for the graphics slice.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from rl_agents_torch.configuration import serialize
from rl_agents_torch.trainer import logger as run_logger
from rl_agents_torch.trainer.metrics import NullWriter
from rl_agents_torch.utils.math import near_split

logger = logging.getLogger(__name__)


class Transition(NamedTuple):
    state: object
    action: object
    reward: object
    next_state: object
    terminal: object
    info: dict


def capped_cubic_video_schedule(episode: int) -> bool:
    """True on perfect cubes below 1000, then every 1000 episodes."""
    if episode < 1000:
        return int(round(episode ** (1.0 / 3))) ** 3 == episode
    return episode % 1000 == 0


class Evaluation:
    OUTPUT_FOLDER = "out"
    SAVED_MODELS_FOLDER = "saved_models"
    RUN_FOLDER = "run_{}_{}"
    METADATA_FILE = "metadata.{}.json"
    LOGGING_FILE = "logging.{}.log"
    EPISODES_FILE = "episodes.jsonl"

    def __init__(self,
                 env,
                 agent,
                 directory=None,
                 run_directory=None,
                 num_episodes: int = 1000,
                 training: bool = False,
                 sim_seed: Optional[int] = None,
                 recover=None,
                 display_env: bool = False,
                 display_agent: bool = False,
                 display_rewards: bool = False,
                 close_env: bool = True,
                 step_callback_fn: Optional[Callable] = None):
        """``step_callback_fn(episode, env, agent, transition, writer)`` is
        called after every env step with ``transition = (observation, action,
        reward, next_observation, done, truncated, info)``."""
        if display_env or display_agent or display_rewards:
            raise NotImplementedError(
                "display_env, display_agent and display_rewards: the viewers and recorders "
                "are not ported yet (slice 11, the graphics)")
        self.env = env
        self.agent = agent
        self.num_episodes = num_episodes
        self.training = training
        if sim_seed is None:
            sim_seed = int(np.random.default_rng().integers(0, 1_000_000))
        self.sim_seed = sim_seed
        self.close_env = close_env
        self.step_callback_fn = step_callback_fn

        self.directory = Path(directory or self.default_directory)
        self.run_directory = self.directory / (run_directory or self.default_run_directory)
        self.run_directory.mkdir(parents=True, exist_ok=True)
        self.episode = 0
        self.writer = self._make_writer()
        self.agent.set_writer(self.writer)
        self.agent.set_directory(self.run_directory)
        self.agent.evaluation = self
        self._log_handler = self.write_logging()
        self.write_metadata()
        self.episode_rewards: List[float] = []
        self.filtered_agent_stats = 0.0
        self.best_agent_stats = (-np.inf, 0)
        self.observation = None
        self.recover = recover
        if self.recover:
            self.load_agent_model(self.recover)

    def _make_writer(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return NullWriter()
        return SummaryWriter(str(self.run_directory))

    def train(self):
        self.training = True
        if self.agent.config.get("fused") and hasattr(self.agent, "train_fused") \
                and hasattr(self.env, "functional"):
            self.run_fused_training()
        elif getattr(self.agent, "batched", False):
            self.run_batched_episodes()
        else:
            self.run_episodes()
        self.close()

    def run_fused_training(self):
        """Whole-run fused actor-learner training (agent config ``"fused":
        true``): the agent trains as one on-device loop
        (``parallel/actor_learner.py``); ``close`` then checkpoints it."""
        logger.info("Fused on-device training: %d episode-equivalents", self.num_episodes)
        ema = self.agent.train_fused(self.env, self.num_episodes, writer=self.writer)
        logger.info("Fused training done: EMA completed-episode return %.1f", ema)

    def test(self):
        self.training = False
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
            self.after_some_episodes(self.episode, rewards)

    def run_batched_episodes(self):
        """Alternate sample collection and model fitting (reference:
        evaluation.py:196-246): ``num_episodes`` episodes of 14 steps are
        split into batches of at most the agent's ``batch_size`` samples; each
        batch is collected by the training agent, recorded, and fitted by
        ``agent.update()``."""
        episode = 0
        episode_duration = 14
        batch_sizes = near_split(self.num_episodes * episode_duration,
                                 size_bins=self.agent.config["batch_size"])
        self.agent.reset()
        for batch, batch_size in enumerate(batch_sizes):
            logger.info("[BATCH=%d/%d] collecting %d samples", batch + 1, len(batch_sizes),
                        batch_size)
            collect_start = time.time()
            trajectories = self.collect_samples_host(batch_size, seed=batch, batch=batch)
            # each finished episode is given its share of the batch's time
            collect_duration = time.time() - collect_start
            total_steps = sum(len(t) for t in trajectories) or 1
            for trajectory in trajectories:
                if trajectory and trajectory[-1].terminal:
                    self.after_all_episodes(
                        episode, [t.reward for t in trajectory],
                        duration=collect_duration * len(trajectory) / total_steps)
                episode += 1
                for t in trajectory:
                    self.agent.record(*t)
            self.agent.update()

    def collect_samples_host(self, count: int, seed: int, batch: int):
        """``count`` transitions collected by the training agent, as a list
        of trajectories; pure exploration on batch 0, the env and the agent
        seeded with the batch number (reference: evaluation.py:248-290)."""
        env, agent = self.env, self.agent
        if batch == 0 and hasattr(agent, "explore"):
            agent.explore(True)
        agent.seed(seed)
        state, _ = env.reset(seed=seed)
        episodes, trajectory = [], []
        for _ in range(count):
            action = agent.act(state)
            next_state, reward, done, truncated, info = env.step(action)
            terminal = bool(done) or bool(truncated)
            trajectory.append(Transition(state, action, reward, next_state, terminal, info))
            if terminal:
                state, _ = env.reset()
                episodes.append(trajectory)
                trajectory = []
            else:
                state = next_state
        if trajectory:
            episodes.append(trajectory)
        if batch == 0 and hasattr(agent, "explore"):
            agent.explore(False)
        return episodes

    def step(self):
        """plan -> env.step -> record (reference: evaluation.py:163-194)."""
        actions = self.agent.plan(self.observation)
        if actions is None or (hasattr(actions, "__len__") and len(actions) == 0):
            raise Exception("The agent did not plan any action")

        previous_observation, action = self.observation, actions[0]
        self.observation, reward, done, truncated, info = self.env.step(action)
        terminal = bool(done) or bool(truncated)
        if self.step_callback_fn is not None:
            self.step_callback_fn(self.episode, self.env, self.agent,
                                  (previous_observation, action, reward, self.observation,
                                   done, truncated, info), self.writer)
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

    def after_some_episodes(self, episode: int, rewards,
                            best_increase: float = 1.1, episodes_window: int = 50):
        """Checkpoint on the cubic schedule, and as "best" when the filtered
        score beats the best by ``best_increase`` after a window."""
        if not self.training:
            return
        if capped_cubic_video_schedule(episode):
            self.save_agent_model(episode)
        best_reward, best_episode = self.best_agent_stats
        self.filtered_agent_stats += 1 / episodes_window * (np.sum(rewards) - self.filtered_agent_stats)
        if self.filtered_agent_stats > best_increase * best_reward \
                and episode >= best_episode + episodes_window:
            self.best_agent_stats = (self.filtered_agent_stats, episode)
            self.save_agent_model("best")

    def save_agent_model(self, identifier, do_save: bool = True):
        """Save the agent to ``saved_models/latest.tar`` and to the run's
        ``checkpoint-<identifier>.tar``; return the latter's path (False for
        a stateless agent, None when ``do_save`` is false)."""
        permanent_folder = self.directory / self.SAVED_MODELS_FOLDER
        os.makedirs(permanent_folder, exist_ok=True)
        if not do_save:
            return None
        self.agent.save(filename=permanent_folder / "latest.tar")
        episode_path = self.agent.save(filename=self.run_directory / f"checkpoint-{identifier}.tar")
        if episode_path:
            logger.info("Saved %s model to %s", self.agent.__class__.__name__, episode_path)
        return episode_path

    def load_agent_model(self, model_path):
        """Load the agent from ``model_path``; ``True`` names
        ``saved_models/latest.tar``, and a relative name that does not exist
        is looked up in ``saved_models/``."""
        if model_path is True:
            model_path = self.directory / self.SAVED_MODELS_FOLDER / "latest.tar"
        if isinstance(model_path, str):
            model_path = Path(model_path)
            if not model_path.exists():
                model_path = self.directory / self.SAVED_MODELS_FOLDER / model_path
        try:
            model_path = self.agent.load(filename=model_path)
            if model_path:
                logger.info("Loaded %s model from %s", self.agent.__class__.__name__, model_path)
        except FileNotFoundError:
            logger.warning("No pre-trained model found at the desired location.")

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
        """The run's DEBUG log file (``trainer/logger.py``), and the default
        stream configuration when nothing configured logging before (the
        CLI's ``--verbose`` does)."""
        if not logging.getLogger().handlers:
            run_logger.configure()
        file_infix = f"{id(self.env)}.{os.getpid()}"
        return run_logger.add_file_handler(self.run_directory
                                           / self.LOGGING_FILE.format(file_infix))

    def reset(self, seed: int = 0):
        """Seeding protocol (reference: evaluation.py:372-376): env reset with
        the episode seed; agent seeded with sim_seed + episode."""
        seed = self.sim_seed + seed
        self.observation, _ = self.env.reset(seed=seed)
        self.agent.seed(seed)
        self.agent.reset()

    def close(self):
        if self.training:
            self.save_agent_model("final")
        self.writer.close()
        logging.getLogger().removeHandler(self._log_handler)
        self._log_handler.close()
        if self.close_env:
            self.env.close()
