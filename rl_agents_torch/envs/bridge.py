"""Host gymnasium bridge: the fallback of ``factory.load_environment`` for an
id that no functional env serves.

Port of ``rl_agents_tpu/envs/bridge.py`` (reference: factory.py:59-94 loads
gym envs via gym.make + unwrapped.configure). It wraps a real gymnasium
environment behind the surface that the harness and the object-path agents
expect; forking deep-copies it, like the reference's ``safe_deepcopy_env``.
Nothing here touches the device: the env runs on the host, and gymnasium is
imported only when a bridge is made.
"""
from __future__ import annotations

import copy
import importlib
import logging
from typing import Dict

logger = logging.getLogger(__name__)

# fields that cannot be deep-copied (reference: factory.py:119-134)
_UNCOPYABLE = ("viewer", "_monitor", "grid_render", "video_recorder", "_record_video_wrapper")


class GymBridge:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, seed=None, **kwargs):
        return self.env.reset(seed=seed, **kwargs)

    def step(self, action):
        return self.env.step(action)

    def fork(self) -> "GymBridge":
        env = self.env
        saved = {}
        target = env.unwrapped if hasattr(env, "unwrapped") else env
        for attr in _UNCOPYABLE:
            if hasattr(target, attr):
                saved[attr] = getattr(target, attr)
                setattr(target, attr, None)
        try:
            clone = copy.deepcopy(env)
        finally:
            for attr, value in saved.items():
                setattr(target, attr, value)
        return GymBridge(clone)

    def preprocess(self, name, args):
        target = self.env.unwrapped if hasattr(self.env, "unwrapped") else self.env
        if hasattr(target, name):
            result = getattr(target, name)(*args)
            if result is not None:
                return GymBridge(result)
            return self
        logger.warning("gym env has no preprocessor %s", name)
        return self


def make_gym_env(env_config: Dict) -> GymBridge:
    import gymnasium as gym

    if "import_module" in env_config:
        try:
            importlib.import_module(env_config["import_module"])
        except ImportError:
            logger.warning("Could not import module %s", env_config["import_module"])
    env = gym.make(env_config["id"], render_mode=env_config.get("render_mode"))
    target = env.unwrapped
    if hasattr(target, "configure"):
        target.configure(env_config)
        env.reset()
    return GymBridge(env)
