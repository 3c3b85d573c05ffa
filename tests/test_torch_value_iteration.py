"""Dynamic programming in the PyTorch port against the JAX package: the
Bellman expectation in its three encodings, the fixed point's stopping rule,
``plan_trajectory``, Value Iteration on finite MDPs, Sailing (``vi.json``)
and highway's time-to-collision view, and Robust Value Iteration on the four
robust corpus configs.

Deterministic and sparse Q tables are equal to JAX's (the port writes the
sparse sum as XLA's chain of fused multiply-adds). The stochastic
contraction sums in another order than XLA's dot, so its iterates agree
within 1e-6 of their largest entry; the test pins the update at which the
port stopped against the one at which JAX stops, and the one input where
they differ by one update (ROADMAP.md §3)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.dynamic_programming import bellman as tb
from rl_agents_torch.convert import highway_state_from_numpy
from rl_agents_torch.envs import highway as th
from rl_agents_torch.envs import sailing as ts
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_tpu.agents.dynamic_programming import bellman as jb
from rl_agents_tpu.envs import highway as jh
from rl_agents_tpu.envs import sailing as js
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
STOCHASTIC_REL = 1e-6
MODES = ("deterministic", "stochastic", "sparse")


def _random_mdp(mode, S, A, K, seed, terminal_share=0.1):
    rng = np.random.default_rng(seed)
    reward = rng.normal(size=(S, A)).astype(np.float32)
    terminal = rng.random(S) < terminal_share
    nxt = np.zeros((), np.int64)
    if mode == "deterministic":
        transition = rng.integers(0, S, (S, A))
    elif mode == "stochastic":
        transition = rng.random((S, A, S)).astype(np.float32)
        transition /= transition.sum(-1, keepdims=True)
    else:
        transition = rng.random((S, A, K)).astype(np.float32)
        transition /= transition.sum(-1, keepdims=True)
        nxt = rng.integers(0, S, (S, A, K))
    jax_model = jb.BellmanModel(
        jnp.asarray(transition.astype(np.int32) if mode == "deterministic" else transition),
        jnp.asarray(reward), jnp.asarray(terminal), jnp.asarray(nxt.astype(np.int32)))
    torch_model = tb.BellmanModel(torch.tensor(transition), torch.tensor(reward),
                                  torch.tensor(terminal), torch.tensor(nxt))
    return jax_model, torch_model


@pytest.mark.parametrize("mode", MODES)
def test_bellman_expectation_matches_jax(mode):
    jax_model, torch_model = _random_mdp(mode, 50, 4, 3, seed=1)
    value = np.random.default_rng(2).normal(size=50).astype(np.float32)
    want = np.asarray(jax.jit(lambda m, v: jb.bellman_expectation(m, v, 0.95, mode))(
        jax_model, jnp.asarray(value)))
    got = tb.bellman_expectation(torch_model, torch.tensor(value), 0.95, mode).numpy()
    if mode == "stochastic":
        np.testing.assert_allclose(got, want, rtol=0, atol=STOCHASTIC_REL * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


# The fault of ROADMAP.md §3: on this input the port's stochastic fixed point
# meets the stopping rule one update before JAX's does (update 53 against
# 54), because the contraction's summation order differs by ulps.
STOPS_ONE_UPDATE_EARLY = {("stochastic", 0.9)}


@pytest.mark.parametrize("gamma", [0.9, 0.99, 1.0])
@pytest.mark.parametrize("mode", MODES)
def test_state_action_value_matches_jax(mode, gamma):
    jax_model, torch_model = _random_mdp(mode, 40, 4, 3, seed=int(gamma * 100))
    want = np.asarray(jb.state_action_value(jax_model, gamma, mode, 100))
    got = tb.state_action_value(torch_model, gamma, mode, 100).numpy()
    updates = tb.state_action_value.iterations
    if updates == 100:  # the cap stopped the port: JAX ran to it too
        same_iterate = want
    else:
        # the port stopped at update u and returned iterate u - 1; JAX's
        # fixed point capped at u - 1 updates is its iterate u - 1
        same_iterate = np.asarray(jb.state_action_value(jax_model, gamma, mode, updates - 1))
    if mode == "stochastic":
        np.testing.assert_allclose(got, same_iterate, rtol=0,
                                   atol=STOCHASTIC_REL * np.abs(same_iterate).max())
    else:
        np.testing.assert_array_equal(got, same_iterate)
    if (mode, gamma) in STOPS_ONE_UPDATE_EARLY:
        assert updates == 53 and not np.array_equal(same_iterate, want)
        np.testing.assert_array_equal(
            np.asarray(jb.state_action_value(jax_model, gamma, mode, updates)), want)
    else:  # JAX returned the same iterate
        np.testing.assert_array_equal(same_iterate, want)
        if updates < 100:
            before = np.asarray(jb.state_action_value(jax_model, gamma, mode, updates - 2))
            assert not np.array_equal(before, want)


def test_early_stop_returns_the_iterate_before_the_converged_update():
    """A discounted chain converges well inside the cap; the result is the
    pre-update iterate, as the reference breaks before assigning."""
    jax_model, torch_model = _random_mdp("deterministic", 30, 3, 1, seed=5, terminal_share=0.3)
    got = tb.state_action_value(torch_model, 0.5, "deterministic", 100)
    updates = tb.state_action_value.iterations
    assert 1 < updates < 100
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jb.state_action_value(jax_model, 0.5, "deterministic", 100)))
    after = tb.bellman_expectation(torch_model, got.amax(dim=-1), 0.5, "deterministic")
    assert not torch.equal(after, got)
    assert bool(tb.allclose(got, after, 1e-5, 1e-8))


@pytest.mark.parametrize("mode", ["deterministic", "stochastic"])
def test_plan_trajectory_matches_jax(mode):
    jax_model, torch_model = _random_mdp(mode, 20, 3, 1, seed=9, terminal_share=0.15)
    q = np.asarray(jb.state_action_value(jax_model, 0.9, mode, 50))
    for state in (0, 3, 7):
        want = jb.plan_trajectory(jax_model, jnp.asarray(q), jnp.asarray(state), mode, 12)
        got = tb.plan_trajectory(torch_model, torch.tensor(q), state, mode, 12)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["anti_vi", "doors", "large", "trap"])
def test_robust_value_iteration_on_the_corpus_matches_jax(name):
    family = CONFIGS / "FiniteMDPEnv" / name
    env_j = jax_load_environment(family / "env_1.json")
    env_t = torch_load_environment(family / "env_1.json", device="cpu")
    config = load_agent_config(family / "agents" / "robust_value_iteration.json")
    agent_j = jax_load_agent(dict(config), env_j)
    agent_t = torch_load_agent(load_agent_config(family / "agents" /
                                                 "robust_value_iteration.json"), env_t,
                               device="cpu")
    np.testing.assert_array_equal(agent_t.state_action_value, agent_j.state_action_value)
    np.testing.assert_array_equal(agent_t.get_state_value(), agent_j.get_state_value())
    for state in range(agent_t.state_action_value.shape[0]):
        assert agent_t.act(state) == agent_j.act(state)
    # and the plain agent, where the family has one, on its env configs
    if not (family / "agents" / "value_iteration.json").is_file():
        return
    for env_file in ("env_1.json", "env_2.json"):
        env_j = jax_load_environment(family / env_file)
        env_t = torch_load_environment(family / env_file, device="cpu")
        vi = load_agent_config(family / "agents" / "value_iteration.json")
        vi_j, vi_t = jax_load_agent(dict(vi), env_j), torch_load_agent(dict(vi), env_t,
                                                                       device="cpu")
        np.testing.assert_array_equal(vi_t.state_action_value, vi_j.state_action_value)
        assert vi_t.act(env_t.reset(seed=0)[0]) == vi_j.act(env_j.reset(seed=0)[0])


def test_value_iteration_on_sailing_matches_jax():
    """``SailingEnv/agents/vi.json`` on ``SailingEnv/env.json`` (size 8, 512
    states, sparse over the three wind outcomes): equal Q tables, and the
    agent reads the state index from the accessor."""
    handle_j = js.make({"size": 8})
    handle_t = ts.make({"size": 8}, device="cpu")
    config = load_agent_config(CONFIGS / "SailingEnv" / "agents" / "vi.json")
    agent_j = jax_load_agent(dict(config), handle_j)
    agent_t = torch_load_agent(dict(config), handle_t, device="cpu")
    assert agent_t.mode == "sparse" and not agent_t.rederive_each_act
    np.testing.assert_array_equal(agent_t.state_action_value, agent_j.state_action_value)
    obs_t, _ = handle_t.reset(seed=4)
    assert agent_t.act(obs_t) == int(np.argmax(agent_j.state_action_value[handle_t.mdp.state]))


def test_value_iteration_on_highway_ttc_view_matches_jax():
    """``HighwayEnv/agents/ValueIterationAgent/baseline.json``: the agent
    calls ``to_finite_mdp`` again at every act, around the current state."""
    config = {"vehicles_count": 8, "lanes_count": 3, "duration": 20}
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    agent_config = load_agent_config(CONFIGS / "HighwayEnv" / "agents" / "ValueIterationAgent" /
                                     "baseline.json")
    agent_j = jax_load_agent(dict(agent_config), handle_j)
    agent_t = torch_load_agent(dict(agent_config), handle_t, device="cpu")
    assert agent_t.rederive_each_act and agent_t.config["iterations"] == 10
    obs, _ = handle_j.reset(seed=11)
    for step in range(4):
        state = jax.tree.map(lambda x: np.asarray(x)[None], handle_j.state)
        handle_t.state = highway_state_from_numpy(state, device="cpu")
        action = agent_j.act(obs)
        assert agent_t.act(obs) == action
        np.testing.assert_array_equal(agent_t.state_action_value, agent_j.state_action_value)
        assert agent_t.mdp.state == agent_j.mdp.state
        obs, *_ = handle_j.step(action)
