"""The simple agents of the PyTorch port against the JAX package's:
``RandomUniformAgent`` draws the same actions from the same seed (its
threefry stream replayed on the host), and ``OpenLoopAgent`` replays the
corpus's action sequences step for step."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rl_agents_torch.envs.base import Box as TorchBox
from rl_agents_torch.envs.base import Discrete as TorchDiscrete
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_torch.utils import noise as tn
from rl_agents_tpu.envs.base import Box as JaxBox
from rl_agents_tpu.envs.base import Discrete as JaxDiscrete
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
OPEN_LOOP = [  # (env config, agent config) of the corpus on ported envs
    ("HighwayEnv/env.json", "HighwayEnv/agents/OpenLoopAgent/idle.json"),
    ("IntersectionEnv/env.json", "IntersectionEnv/agents/OpenLoopAgent/idle.json"),
    ("RoundaboutEnv/env.json", "RoundaboutEnv/agents/OpenLoopAgent.json"),
    ("RoundaboutEnv/env.json", "RoundaboutEnv/agents/OpenLoopAgent/idle.json"),
]


@dataclasses.dataclass
class _SpaceEnv:
    action_space: object


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_threefry_keys_and_randint_replay_jax(seed):
    key, key_t = jax.random.PRNGKey(seed), tn.prng_key(seed)
    assert tuple(int(x) for x in np.asarray(key)) == key_t
    for n in (2, 3, 5, 1000, 2**20 + 3):
        key, sub = jax.random.split(key)
        key_t, sub_t = tn.threefry_split(key_t)
        assert tuple(int(x) for x in np.asarray(sub)) == sub_t
        assert tn.threefry_randint(sub_t, n) == int(jax.random.randint(sub, (), 0, n))
    low, high = np.array([-1.0, 0.0], np.float32), np.array([1.0, 1e3], np.float32)
    np.testing.assert_array_equal(tn.threefry_uniform(sub_t, (3, 2), low, high),
                                  np.asarray(jax.random.uniform(sub, (3, 2), minval=low,
                                                                maxval=high)))


def test_random_uniform_agent_draws_jax_actions_on_highway():
    """``HighwayEnv/agents/RandomUniformAgent/random.json``: the same actions
    from the default key and after each seed."""
    config = load_agent_config(CONFIGS / "HighwayEnv" / "agents" / "RandomUniformAgent" /
                               "random.json")
    env_j = jax_load_environment(CONFIGS / "HighwayEnv" / "env.json")
    env_t = torch_load_environment(CONFIGS / "HighwayEnv" / "env.json", device="cpu")
    agent_j, agent_t = jax_load_agent(dict(config), env_j), torch_load_agent(dict(config), env_t,
                                                                             device="cpu")
    for seed in (None, 0, 7):
        assert agent_t.seed(seed) == agent_j.seed(seed) == [seed]
        got = [agent_t.act(None) for _ in range(40)]
        assert got == [agent_j.act(None) for _ in range(40)]
        assert set(got) == set(range(5))
        agent_t.reset()
        assert agent_t.plan(None) == [agent_j.plan(None)[0]]


def test_random_uniform_agent_samples_a_box_as_jax():
    space_j = JaxBox(low=np.array([-1.0, -np.inf]), high=np.array([2.0, np.inf]), shape=(2,))
    space_t = TorchBox(low=space_j.low, high=space_j.high, shape=(2,))
    from rl_agents_torch.agents.simple import RandomUniformAgent as TorchAgent
    from rl_agents_tpu.agents.simple import RandomUniformAgent as JaxAgent

    agent_j, agent_t = JaxAgent(_SpaceEnv(space_j)), TorchAgent(_SpaceEnv(space_t), device="cpu")
    agent_j.seed(3)
    agent_t.seed(3)
    for _ in range(5):
        np.testing.assert_array_equal(agent_t.act(None), agent_j.act(None))
    discrete = TorchAgent(_SpaceEnv(TorchDiscrete(4)), device="cpu")
    assert discrete.act(None) == JaxAgent(_SpaceEnv(JaxDiscrete(4))).act(None)


@pytest.mark.parametrize("env_file,agent_file", OPEN_LOOP)
def test_open_loop_agent_on_the_corpus_matches_jax(env_file, agent_file):
    config = load_agent_config(CONFIGS / agent_file)
    env_j = jax_load_environment(CONFIGS / env_file)
    env_t = torch_load_environment(CONFIGS / env_file, device="cpu")
    agent_j, agent_t = jax_load_agent(dict(config), env_j), torch_load_agent(dict(config), env_t,
                                                                             device="cpu")
    if not config["actions"]:
        # the corpus's idle.json gives no action and a "default_action" that
        # neither package reads: both raise on the first act and plan
        for agent in (agent_j, agent_t):
            with pytest.raises(IndexError):
                agent.act(None)
            with pytest.raises(IndexError):
                agent.plan(None)
        return
    for step in range(8):
        assert agent_t.plan(None) == agent_j.plan(None)
        assert agent_t.act(None) == agent_j.act(None)
    agent_t.set_time(2)
    agent_j.set_time(2)
    assert agent_t.plan(None) == agent_j.plan(None)
    agent_t.reset()
    agent_j.reset()
    assert agent_t.t == agent_j.t == 0
    assert agent_t.seed(5) == agent_j.seed(5)


# ---------------------------------------------------------------------------
# The corpus: every config of the seven agents of this slice constructs
# ---------------------------------------------------------------------------

SLICE_AGENTS = {"ValueIterationAgent", "RobustValueIterationAgent", "RandomUniformAgent",
                "OpenLoopAgent", "MCTSWithPriorPolicyAgent", "FTQAgent", "BFTQAgent"}


def _family_env_config(family: Path):
    """The family's env config, by the rule of tests/test_corpus_construction.py:
    the first ``env*.json`` (then any JSON) whose id the port registers."""
    from rl_agents_torch.factory import ENV_REGISTRY

    candidates = sorted(family.glob("env*.json")) + sorted(
        p for p in family.glob("*.json") if not p.name.startswith("env"))
    for candidate in candidates:
        config = json.loads(candidate.read_text())
        if isinstance(config, dict) and config.get("id") in ENV_REGISTRY:
            return candidate
    return None


def _class_name(config):
    return str(config.get("__class__", "")).rsplit(".", 1)[-1].rstrip("'>")


def _slice_corpus():
    cases = []
    for path in sorted(CONFIGS.rglob("*.json")):
        if path.name.startswith("env") or "benchmark" in path.name:
            continue
        config = json.loads(path.read_text())
        if not isinstance(config, dict) or not ({"__class__", "base_config"} & set(config)):
            continue
        name = _class_name(load_agent_config(path))
        if name not in SLICE_AGENTS:
            continue
        family = CONFIGS / path.relative_to(CONFIGS).parts[0]
        env_path = _family_env_config(family)
        if env_path is not None:
            cases.append((str(path.relative_to(CONFIGS)), str(env_path.relative_to(CONFIGS))))
    return cases


SLICE_CORPUS = _slice_corpus()


def test_the_slice_corpus_is_what_the_audit_counted():
    names = [_class_name(load_agent_config(CONFIGS / agent)) for agent, _ in SLICE_CORPUS]
    assert set(names) == SLICE_AGENTS
    # the agents the corpus audit found blocked on them, with the parking and
    # lane-keeping configs since their envs are ported
    counts = {name: names.count(name) for name in SLICE_AGENTS}
    assert counts == {"FTQAgent": 18, "ValueIterationAgent": 9, "MCTSWithPriorPolicyAgent": 9,
                      "BFTQAgent": 5, "RobustValueIterationAgent": 4, "OpenLoopAgent": 6,
                      "RandomUniformAgent": 3}


@pytest.mark.parametrize("agent_file,env_file", SLICE_CORPUS)
def test_slice_corpus_config_constructs(agent_file, env_file, tmp_path, monkeypatch):
    """Each config on its family's env, on the CPU. The prior planners whose
    ``model_save`` names a DQN artifact get one, saved with ``DQNAgent.save``
    at that path."""
    env = torch_load_environment(CONFIGS / env_file, device="cpu")
    config = load_agent_config(CONFIGS / agent_file)
    prior = config.get("prior_agent", {})
    if "model_save" in prior:
        saved = torch_load_agent({k: v for k, v in prior.items() if k != "model_save"}, env,
                                 device="cpu")
        saved.save(tmp_path / prior["model_save"])
        monkeypatch.chdir(tmp_path)
    agent = torch_load_agent(config, env, device="cpu")
    assert type(agent).__name__ in SLICE_AGENTS
