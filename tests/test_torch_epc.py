"""The EPC agents of the PyTorch port against the JAX package over 5 steps:
``RobustEPCAgent`` and ``NominalEPCAgent`` at ``tests/agents/test_robust.py``'s
configuration and at ``ObstacleEnv/RobustEPCAgent.json``, ``ConstrainedEPCAgent``
at the test's; ellipsoids and polytopes equal (host float64 in both), the
observations, actions and the OPD sub-agent's robust tree equal. And the
corpus configs that fail in JAX fail the same way in the port."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch.agents.robust.constrained_epc import ConstrainedEPCAgent
from rl_agents_torch.agents.robust.robust_epc import NominalEPCAgent, RobustEPCAgent
from rl_agents_torch.configuration import load_json_config
from rl_agents_torch.convert import tree_to_numpy
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_tpu.agents.robust.constrained_epc import ConstrainedEPCAgent as JaxConstrainedEPC
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
# tests/agents/test_robust.py:104-113
TEST_CONFIG = {
    "__class__": "RobustEPCAgent",
    "A": [[0.0, 1.0], [0.0, 0.0]], "B": [[0.0], [1.0]], "D": [[0.0], [1.0]],
    "phi": [[[0.0, 0.0], [0.0, -1.0]]], "sigma": [[1.0, 0.0], [0.0, 1.0]],
    "omega": [[0.0], [0.0]],
    "sub_agent": {"__class__": "DeterministicPlannerAgent", "budget": 20, "gamma": 0.9},
}
LINEAR_ENV = {"id": "linear-system", "max_episode_steps": 30}
TREE_FIELDS = ("reward", "value_lower", "value_upper")


def _episode(env_config, agent_config, steps=5):
    env_j, env_t = jax_load_environment(env_config), load_environment(env_config, device="cpu")
    agent_j, agent_t = jax_load_agent(agent_config, env_j), load_agent(agent_config, env_t,
                                                                       device="cpu")
    assert type(agent_t).__name__ == type(agent_j).__name__
    obs_j, _ = env_j.reset(seed=0)
    obs_t, _ = env_t.reset(seed=0)
    actions = []
    for _ in range(steps):
        action = agent_t.act(obs_t)
        assert action == agent_j.act(obs_j)
        actions.append(action)
        a0_t, da_t = agent_t.polytope()
        a0_j, da_j = agent_j.polytope()
        np.testing.assert_array_equal(a0_t, a0_j)
        np.testing.assert_array_equal(np.array(da_t), np.array(da_j))
        tree_t = tree_to_numpy(agent_t.sub_agent.last_plan_data)
        tree_j = agent_j.sub_agent.last_plan_data
        used = int(tree_j.used)
        assert int(tree_t.used[0]) == used
        for field in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(tree_t, field)[0, :used],
                                          np.asarray(getattr(tree_j, field))[:used], err_msg=field)
        out_j, out_t = env_j.step(action), env_t.step(action)
        for k in out_t[0]:
            np.testing.assert_array_equal(out_t[0][k], out_j[0][k])
        agent_j.record(obs_j, action, out_j[1], out_j[0], out_j[2], out_j[4])
        agent_t.record(obs_t, action, out_t[1], out_t[0], out_t[2], out_t[4])
        obs_j, obs_t = out_j[0], out_t[0]
    assert len(agent_t.ellipsoids) == len(agent_j.ellipsoids) == steps + 1
    for (theta_t, g_t, beta_t), (theta_j, g_j, beta_j) in zip(agent_t.ellipsoids,
                                                              agent_j.ellipsoids):
        np.testing.assert_array_equal(theta_t, theta_j)
        np.testing.assert_array_equal(g_t, g_j)
        assert beta_t == beta_j
    return agent_t, actions


@pytest.mark.parametrize("name", ["RobustEPCAgent", "NominalEPCAgent"])
def test_test_configuration_matches_jax(name):
    agent, _ = _episode(LINEAR_ENV, dict(TEST_CONFIG, __class__=name))
    assert isinstance(agent, NominalEPCAgent if name == "NominalEPCAgent" else RobustEPCAgent)
    theta, _, _ = agent.ellipsoids[-1]
    assert theta.shape == (1,) and 0.0 <= theta[0] <= 1.0
    if name == "NominalEPCAgent":
        assert np.allclose(agent.polytope()[1][0], 0)
        assert agent.config["omega"] == [[0.0], [0.0]]


def test_obstacle_env_config_matches_jax():
    """``ObstacleEnv/RobustEPCAgent.json`` on ``ObstacleEnv/env.json``: the
    robust fork runs the interval predictor with omega = 0.01 inside OPD."""
    agent, _ = _episode(load_json_config(CONFIGS / "ObstacleEnv" / "env.json"),
                        load_json_config(CONFIGS / "ObstacleEnv" / "RobustEPCAgent.json"))
    robust = agent.robust_env
    assert robust.functional.robust and robust.functional.n_vertices == 2
    assert float(robust.params.omega_hi[0]) == pytest.approx(0.01)
    assert robust.params is not agent.env.params  # a fork: the plant keeps its params
    assert not agent.env.functional.robust


def test_constrained_epc_matches_jax():
    """tests/agents/test_robust.py:133-156, 3 plans: the pole-placed gain
    (``ensure_stability`` false: no LMI) and the control of each plan."""
    config = dict(TEST_CONFIG, parameter_box=[[0.0], [1.0]], noise_bound=0.1)
    config.pop("__class__")
    env_j = jax_load_environment(LINEAR_ENV)
    env_t = load_environment(LINEAR_ENV, device="cpu")
    agent_j = JaxConstrainedEPC(env_j, dict(config))
    agent_t = ConstrainedEPCAgent(env_t, dict(config), device="cpu")
    obs_j, _ = env_j.reset(seed=0)
    obs_t, _ = env_t.reset(seed=0)
    for _ in range(3):
        plan_t, plan_j = agent_t.plan(obs_t), agent_j.plan(obs_j)
        np.testing.assert_array_equal(plan_t[0], plan_j[0])
        np.testing.assert_array_equal(agent_t.feedback.K0, agent_j.feedback.K0)
        action = 1 if np.ravel(plan_t[0])[0] < 0 else 0
        obs_t, obs_j = env_t.step(action)[0], env_j.step(action)[0]
    assert agent_t.feedback.K0 is not None and agent_t.iteration == 3


# ---------------------------------------------------------------------------
# Latent defects of the JAX package: the port fails as JAX does
# ---------------------------------------------------------------------------

def _first_act(env_file, agent_file, load_env, load, **kw):
    env = load_env(load_json_config(CONFIGS / env_file), **kw)
    agent = load(load_json_config(CONFIGS / agent_file), env, **kw)
    obs, _ = env.reset(seed=0)
    return agent.act(obs)


DEFECTS = [
    # a 4-state polytope written into the 2-state plant's predictor
    ("ObstacleEnv/env.json", "ObstacleEnv/agents/robust-epc.json", TypeError,
     "incompatible shapes"),
    ("ObstacleEnv/env.json", "ObstacleEnv/agents/nominal.json", TypeError,
     "incompatible shapes"),
    # the config's 1-state defaults against the 4-state lane-keeping plant
    ("LaneKeepingEnv/env.json", "LaneKeepingEnv/agents/constrained_epc.json", ValueError,
     "matmul"),
    # the dynamics env has no robust variant
    ("LinearEnv/env.json", "LinearEnv/RobustEPCAgent.json", AttributeError, "robust_variant"),
]


@pytest.mark.parametrize("env_file,agent_file,error,match", DEFECTS)
def test_corpus_configs_that_fail_in_jax_fail_alike(env_file, agent_file, error, match):
    with pytest.raises(error, match=match):
        _first_act(env_file, agent_file, jax_load_environment, jax_load_agent)
    with pytest.raises(error, match=match):
        _first_act(env_file, agent_file, load_environment, load_agent, device="cpu")
