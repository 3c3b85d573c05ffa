"""The feedback controllers of the PyTorch port against the JAX package:
``LinearFeedbackAgent`` (the lane-keeping episode of
``LaneKeepingEnv/agents/linear.json``, bit-equal) and ``IntervalFeedbackAgent``
by pole placement, where the gains are host scipy in both and equal; and the
CartPole linear agent that fails in JAX fails alike."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch.agents.control import (
    IntervalFeedbackAgent,
    LinearFeedbackAgent,
    extended_matrices,
)
from rl_agents_torch.configuration import load_json_config
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_tpu.agents.control import IntervalFeedbackAgent as JaxIntervalFeedbackAgent
from rl_agents_tpu.agents.control import LinearFeedbackAgent as JaxLinearFeedbackAgent
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment
from test_torch_lmi import STABLE

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
OBS = {"interval_min": np.array([0.5, 0.0]), "interval_max": np.array([0.6, 0.1]),
       "reference_state": np.zeros(2), "state": np.array([0.55, 0.05])}


def test_linear_feedback_matches_jax():
    for config in ({"K": [[1.0, 0.5]], "discrete": True}, {"K": [[1.0, 0.5]]}):
        agent_t = LinearFeedbackAgent(None, dict(config), device="cpu")
        agent_j = JaxLinearFeedbackAgent(None, dict(config))
        for state in (np.array([1.0, 0.0]), np.array([-1.0, 0.3]), OBS):
            np.testing.assert_array_equal(agent_t.act(state), agent_j.act(state))
    assert agent_t.plan(np.array([1.0, 0.0]))[0].shape == (1,)


def test_lane_keeping_linear_agent_episode_matches_jax():
    env_config = load_json_config(CONFIGS / "LaneKeepingEnv" / "env.json")
    agent_config = dict(load_json_config(CONFIGS / "LaneKeepingEnv" / "agents" / "linear.json"),
                        K=[[0.1, 0.5, 0.05, 0.2]])  # the corpus gain is zero
    env_j, env_t = jax_load_environment(env_config), load_environment(env_config, device="cpu")
    agent_j, agent_t = jax_load_agent(agent_config, env_j), load_agent(agent_config, env_t,
                                                                       device="cpu")
    obs_j, _ = env_j.reset(seed=0)
    obs_t, _ = env_t.reset(seed=0)
    for _ in range(40):
        action = agent_t.act(obs_t)
        np.testing.assert_array_equal(action, agent_j.act(obs_j))
        out_t, out_j = env_t.step(action), env_j.step(action)
        for k in out_t[0]:
            np.testing.assert_array_equal(out_t[0][k], out_j[0][k])
        assert out_t[1:4] == out_j[1:4]
        obs_t, obs_j = out_t[0], out_j[0]
    assert abs(obs_t["state"][0]) < 0.5  # the gain steers back toward the lane centre


@pytest.mark.parametrize("perturbation_bound", [0.0, 0.2])
def test_pole_placement_gains_match_jax(perturbation_bound):
    """tests/agents/test_robust.py:79-96's double integrator, placed directly
    (the path of ``ConstrainedEPCAgent``'s defaults; its LMI verdict is held
    in tests/test_torch_lmi.py)."""
    config = {"A0": [[0.0, 1.0], [0.0, 0.0]], "dA": [[[0.0, 0.0], [0.0, 0.1]]],
              "B": [[0.0], [1.0]], "D": [[0.0], [1.0]], "perturbation_bound": perturbation_bound,
              "pole_placement": True, "ensure_stability": False}
    agent_t = IntervalFeedbackAgent(None, dict(config), device="cpu")
    agent_j = JaxIntervalFeedbackAgent(None, dict(config))
    agent_t.reset()
    agent_j.reset()
    for name in ("K0", "K1", "K2", "S"):
        np.testing.assert_array_equal(getattr(agent_t, name), getattr(agent_j, name), name)
    np.testing.assert_array_equal(agent_t.act(OBS), agent_j.act(OBS))
    assert agent_t.act(OBS)[0] < 0  # a positive error gets a restoring control


def test_extended_matrices_match_the_jax_test_helper():
    from agents.test_lmi import extended_matrices as jax_test_extended

    for got, want in zip(extended_matrices(**STABLE), jax_test_extended(**STABLE)):
        np.testing.assert_array_equal(got, want)


def test_cartpole_linear_agent_fails_as_in_jax():
    """``CartPoleEnv/LinearAgent.json`` returns a control vector, not a
    discrete action: JAX's CartPole step fails on its shape (ValueError),
    and so does the port's handle."""
    env_file = CONFIGS / "CartPoleEnv" / "env.json"
    agent_file = CONFIGS / "CartPoleEnv" / "LinearAgent.json"
    env_j = jax_load_environment(env_file)
    agent_j = jax_load_agent(load_json_config(agent_file), env_j)
    with pytest.raises(ValueError):
        env_j.step(agent_j.act(env_j.reset(seed=0)[0]))
    env_t = load_environment(env_file, device="cpu")
    agent_t = load_agent(load_json_config(agent_file), env_t, device="cpu")
    with pytest.raises(ValueError, match="discrete action is a scalar"):
        env_t.step(agent_t.act(env_t.reset(seed=0)[0]))
