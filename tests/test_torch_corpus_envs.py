"""The corpus configs of this slice's families under the PyTorch port: every
agent config constructs against its family's env, by the family-env rule of
``tests/test_corpus_construction.py``; every env config builds with the JAX
package's spaces and step limit; and the config that fails in JAX on its
first act fails alike."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch.configuration import load_json_config
from rl_agents_torch.envs.base import Box, Discrete
from rl_agents_torch.factory import ENV_REGISTRY, agent_class, load_agent, load_environment
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent / "scripts" / "configs"
FAMILIES = ("DummyEnv", "GridEnv", "GridWorld", "LaneKeepingEnv", "LineEnv", "LinearEnv",
            "MountainCarEnv", "ObstacleEnv", "ParkingEnv", "Pendulum")
# dangling in the reference itself (class never shipped), as the JAX audit skips it
DEAD = {"ObstacleEnv/agents/model_bias.json"}
EXTRA = ["CartPoleEnv/LinearAgent.json"]  # this slice's agent in an earlier family


def _family_env_config(family: Path):
    """The first env config of the family with a registered id (GridWorld
    spells its env configs empty.json / collect.json)."""
    candidates = sorted(family.glob("env*.json")) + sorted(
        p for p in family.glob("*.json") if not p.name.startswith("env"))
    for cand in candidates:
        cfg = json.loads(cand.read_text())
        if isinstance(cfg, dict) and cfg.get("id") in ENV_REGISTRY:
            return cfg
    return None


def _agent_paths():
    paths = []
    for family in FAMILIES:
        for path in sorted((ROOT / family).rglob("*.json")):
            rel = str(path.relative_to(ROOT))
            if rel in DEAD or path.name.startswith("env") or "benchmark" in path.name:
                continue
            cfg = json.loads(path.read_text())
            if "__class__" in cfg or "base_config" in cfg:
                paths.append(rel)
    return paths + EXTRA


def _env_paths():
    return [str(p.relative_to(ROOT)) for family in FAMILIES
            for p in sorted((ROOT / family).glob("*.json"))
            if json.loads(p.read_text()).get("id") in ENV_REGISTRY]


AGENTS = _agent_paths()


def test_the_slice_covers_the_blocked_configs():
    assert len(AGENTS) == 28
    assert len(_env_paths()) == 16


@pytest.mark.parametrize("rel", AGENTS)
def test_agent_config_constructs(rel):
    family = ROOT / rel.split("/")[0]
    env = load_environment(_family_env_config(family), device="cpu")
    env.reset(seed=0)
    config = load_json_config(ROOT / rel)
    agent = load_agent(config, env, device="cpu")
    assert type(agent) is agent_class(config["__class__"])
    # the JAX package constructs the same agent on the same env
    jax_agent = jax_load_agent(config, jax_load_environment(_family_env_config(family)))
    assert type(jax_agent).__name__ == type(agent).__name__


@pytest.mark.parametrize("rel", _env_paths())
def test_env_config_builds_like_jax(rel):
    config = json.loads((ROOT / rel).read_text())
    env_t, env_j = load_environment(config, device="cpu"), jax_load_environment(config)
    space_t, space_j = env_t.action_space, env_j.action_space
    assert type(space_t).__name__ == type(space_j).__name__
    if isinstance(space_t, Discrete):
        assert space_t.n == space_j.n
    else:
        assert isinstance(space_t, Box) and tuple(space_t.shape) == tuple(space_j.shape)
    assert env_t.spec.max_episode_steps == env_j.spec.max_episode_steps
    obs_t, obs_j = env_t.reset(seed=0)[0], env_j.reset(seed=0)[0]
    if isinstance(obs_t, dict):
        assert {k: v.shape for k, v in obs_t.items()} == \
            {k: np.shape(v) for k, v in obs_j.items()}
    else:
        assert obs_t.shape == np.shape(obs_j)


def test_parking_open_loop_baseline_fails_as_in_jax():
    """``ParkingEnv/OpenLoopAgent/baseline.json`` (``"actions": []``) raises
    IndexError on its first act in both packages."""
    config = load_json_config(ROOT / "ParkingEnv" / "OpenLoopAgent" / "baseline.json")
    env_config = json.loads((ROOT / "ParkingEnv" / "env.json").read_text())
    env_j = jax_load_environment(env_config)
    with pytest.raises(IndexError):
        jax_load_agent(config, env_j).act(env_j.reset(seed=0)[0])
    env_t = load_environment(env_config, device="cpu")
    with pytest.raises(IndexError):
        load_agent(config, env_t, device="cpu").act(env_t.reset(seed=0)[0])
