"""PlaTyPOOS of the PyTorch port against the JAX package.

The schedule is host arithmetic in both packages and the envs are
deterministic, so the plans must be equal: on the two-arm and loop MDPs of
tests/agents/tree_search/test_remaining_planners.py and on the highway env
(``HighwayEnv/agents/PlaTyPOOSAgent/baseline.json``'s gamma, with the
``simplify`` preprocessor), over several agent steps. The per-node statistics
of every layer agree within 1e-6 and the opening counts are equal."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import platypoos as tp
from rl_agents_torch.convert import from_numpy
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu import factory as jax_factory
from rl_agents_tpu.agents.tree_search import platypoos as jp
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}
LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]], "terminal": [0, 0, 0, 0],
        "max_episode_steps": 10000}


def _assert_same_search(agent_t, agent_j):
    assert agent_t.openings == agent_j.openings
    assert agent_t.candidates == agent_j.candidates
    assert len(agent_t._layers) == len(agent_j._layers)
    for layer_t, layer_j in zip(agent_t._layers, agent_j._layers):
        np.testing.assert_array_equal(layer_t.count, layer_j.count)
        np.testing.assert_array_equal(layer_t.done, layer_j.done)
        np.testing.assert_array_equal(layer_t.parent, layer_j.parent)
        np.testing.assert_allclose(layer_t.value, layer_j.value, atol=1e-6)


@pytest.mark.parametrize("name,config,budget", [("two_arm", TWO_ARM, 200),
                                                ("loop", LOOP, 2400)])
def test_mdp_plans_match_jax(name, config, budget):
    env_j = jax_mdp.make(config)
    env_t = torch_mdp.make(config, device="cpu")
    agent_j = jp.PlaTyPOOSAgent(env_j, {"budget": budget, "gamma": 0.8})
    agent_t = tp.PlaTyPOOSAgent(env_t, {"budget": budget, "gamma": 0.8}, device="cpu")
    assert agent_t.config["horizon"] == agent_j.config["horizon"]
    for _ in range(3):
        plan_j = agent_j.plan(None)
        plan_t = agent_t.plan(None)
        assert plan_t == plan_j
        _assert_same_search(agent_t, agent_j)
        env_j.step(plan_j[0])
        env_t.step(plan_t[0])
    if name == "loop":
        assert agent_t.config["horizon"] >= 3 and agent_t.openings >= 10


def test_highway_plans_match_jax():
    """The uncut highway env, ``baseline.json``'s gamma 0.9 and
    ``simplify``, at a budget that explores three layers."""
    config = json.loads((CONFIGS / "HighwayEnv" / "agents" / "PlaTyPOOSAgent" /
                         "baseline.json").read_text())
    config["budget"] = 1200
    env_config = CONFIGS / "HighwayEnv" / "env.json"
    env_j = jax_factory.load_environment(env_config)
    env_t = torch_factory.load_environment(env_config, device="cpu")
    agent_j = jax_factory.load_agent(dict(config), env_j)
    agent_t = torch_factory.load_agent(dict(config), env_t, device="cpu")
    for _ in range(2):
        # the two envs draw other traffic at reset: plan from the JAX env's state
        env_t.state = from_numpy(type(env_t.state),
                                 jax.tree.map(lambda x: np.asarray(x)[None], env_j.state),
                                 device="cpu")
        plan_j = agent_j.plan(None)
        plan_t = agent_t.plan(None)
        assert plan_t == plan_j
        _assert_same_search(agent_t, agent_j)
        env_j.step(plan_j[0])
        env_t.step(plan_t[0])
    assert len(agent_t._layers) >= 3 and agent_t.env_steps > agent_t.openings


def test_one_env_step_per_layer():
    """One batched step per exploration layer and per cross-validation node:
    far fewer env calls than openings."""
    env = torch_mdp.make(LOOP, device="cpu")
    agent = tp.PlaTyPOOSAgent(env, {"budget": 2400, "gamma": 0.8}, device="cpu")
    calls = []
    step = env.functional.transition

    def counting(*args, **kwargs):
        calls.append(args[2].shape[0])
        return step(*args, **kwargs)

    env.functional.transition = counting
    try:
        agent.act(None)
    finally:
        del env.functional.transition
    h_max = agent.config["horizon"]
    assert len(calls) <= h_max + (h_max + 1) * max(len(agent.candidates), 1)
    assert sum(calls) == agent.env_steps
