"""Batch-first KL-OLOP of the PyTorch port against ``jax.vmap(olop_plan)`` of
the JAX package, on the same converted start states.

Actions, plan lengths and the integer arena fields must be equal, and so
must ``cum_reward``; the confidence bounds ``mu_ucb`` and ``value_upper``
agree within 1e-5 (the KL solve's ``log`` differs by ulps between XLA and
torch)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search.batch import olop_plan_batch as torch_olop_batch
from rl_agents_torch.agents.tree_search.olop import OLOPAgent as TorchOLOPAgent
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu.agents.tree_search.batch import olop_plan_batch as jax_olop_batch
from rl_agents_tpu.agents.tree_search.olop import OLOPAgent as JaxOLOPAgent
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
B = 16
# tests/agents/tree_search/test_plan_batch_scale.py:28-33
LOOP_CONFIG = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 1000,
}
LOOP_PLAN = dict(num_actions=3, episodes=10, horizon=3, gamma=0.8, threshold_coeff=4.0)
CARTPOLE_PLAN = dict(num_actions=2, episodes=23, horizon=8, gamma=0.95, threshold_coeff=4.0)
EXACT_FIELDS = ("parent", "children", "depth", "count", "done", "used", "cum_reward")
BOUND_FIELDS = ("mu_ucb", "value_upper")


def _loop_case():
    env_j, params_j = jax_mdp.params_from_config(LOOP_CONFIG)
    env_t, params_t = torch_mdp.params_from_config(LOOP_CONFIG, device="cpu")
    s = np.random.default_rng(0).integers(0, 4, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    return (env_j, params_j, states), (env_t, params_t,
                                       from_numpy(torch_mdp.MDPState, states, device="cpu"))


def _cartpole_case():
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    return (env_j, params_j, states), (
        torch_cartpole.CartPoleEnv(max_episode_steps=200),
        from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        from_numpy(torch_cartpole.CartPoleState, states, device="cpu"))


def _keys(seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _jax_continuation_draws(keys, episodes, horizon, num_actions):
    """The uniform continuation actions ``olop_plan`` draws from each tree's
    key (rl_agents_tpu/agents/tree_search/olop.py:94,118-121), as
    ``[episodes, horizon, B]``."""
    def per_tree(key):
        rows = []
        for _ in range(episodes):
            key, k = jax.random.split(key)
            row = []
            for _ in range(horizon):
                k, ka, _ = jax.random.split(k, 3)
                row.append(jax.random.randint(ka, (), 0, num_actions))
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    draws = jax.jit(jax.vmap(per_tree))(keys)
    return np.transpose(np.asarray(draws), (1, 2, 0))


def _assert_plans_match(jax_out, torch_out):
    actions_j, lengths_j, tree_j = jax_out
    actions_t, lengths_t, tree_t = torch_out
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    tree_t = tree_to_numpy(tree_t)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(tree_t, name), np.asarray(getattr(tree_j, name)),
                                      err_msg=name)
    for name in BOUND_FIELDS:
        got, want = getattr(tree_t, name), np.asarray(getattr(tree_j, name))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=name)
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ucb_type,time_global", [
    ("kullback-leibler", True), ("kullback-leibler", False),
    ("hoeffding", True), ("hoeffding", False)])
def test_loop_mdp_plans_match(ucb_type, time_global):
    (env_j, params_j, states_j), (env_t, params_t, states_t) = _loop_case()
    kw = dict(LOOP_PLAN, ucb_type=ucb_type, time_global=time_global)
    jax_out = jax_olop_batch(env_j, params_j, jax.tree.map(jnp.asarray, states_j), _keys(), **kw)
    torch_out = torch_olop_batch(env_t, params_t, states_t, device="cpu", **kw)
    _assert_plans_match(jax_out, torch_out)


def test_cartpole_plans_match():
    (env_j, params_j, states_j), (env_t, params_t, states_t) = _cartpole_case()
    jax_out = jax_olop_batch(env_j, params_j, jax.tree.map(jnp.asarray, states_j), _keys(),
                             **CARTPOLE_PLAN)
    torch_out = torch_olop_batch(env_t, params_t, states_t, device="cpu", **CARTPOLE_PLAN)
    _assert_plans_match(jax_out, torch_out)
    assert (torch_out[1] == CARTPOLE_PLAN["horizon"]).all()


def test_uniform_continuation_matches_with_jax_draws():
    (env_j, params_j, states_j), (env_t, params_t, states_t) = _loop_case()
    keys = _keys(3)
    draws = _jax_continuation_draws(keys, LOOP_PLAN["episodes"], LOOP_PLAN["horizon"],
                                    LOOP_PLAN["num_actions"])
    assert len(np.unique(draws)) == LOOP_PLAN["num_actions"]
    kw = dict(LOOP_PLAN, continuation_uniform=True)
    jax_out = jax_olop_batch(env_j, params_j, jax.tree.map(jnp.asarray, states_j), keys, **kw)
    torch_out = torch_olop_batch(env_t, params_t, states_t, random_actions=draws,
                                 device="cpu", **kw)
    _assert_plans_match(jax_out, torch_out)


def test_uniform_continuation_draws_from_the_generator():
    _, (env_t, params_t, states_t) = _loop_case()
    kw = dict(LOOP_PLAN, continuation_uniform=True, device="cpu")
    first = torch_olop_batch(env_t, params_t, states_t, torch.Generator().manual_seed(5), **kw)
    again = torch_olop_batch(env_t, params_t, states_t, torch.Generator().manual_seed(5), **kw)
    for a, b in zip(tree_to_numpy(first[2]), tree_to_numpy(again[2])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        torch_olop_batch(env_t, params_t, states_t, **kw)


def test_agent_acts_like_the_jax_agent_on_the_loop_mdp():
    config = json.loads((CONFIGS / "FiniteMDPEnv" / "OLOPAgent.json").read_text())
    env_config = dict(LOOP_CONFIG, max_episode_steps=20)
    env_j = jax_mdp.make(env_config)
    env_t = torch_mdp.make(env_config, device="cpu")
    obs_j, _ = env_j.reset(seed=0)
    obs_t, _ = env_t.reset(seed=0)
    agent_j = JaxOLOPAgent(env_j, dict(config))
    agent_t = TorchOLOPAgent(env_t, dict(config), device="cpu")
    assert (agent_t.config["episodes"], agent_t.config["horizon"]) == \
        (agent_j.config["episodes"], agent_j.config["horizon"])
    for _ in range(5):
        action_j, action_t = agent_j.act(obs_j), agent_t.act(obs_t)
        assert action_t == action_j
        obs_j, reward_j, *_ = env_j.step(action_j)
        obs_t, reward_t, *_ = env_t.step(action_t)
        assert int(obs_t) == int(obs_j) and reward_t == reward_j


@pytest.mark.parametrize("relpath", ["FiniteMDPEnv/agents/olop.json",
                                     "FiniteMDPEnv/haystack/agents/olop.json",
                                     "FiniteMDPEnv/haystack/agents/kl-olop.json"])
def test_string_upper_bound_plans_as_the_dict_form(relpath):
    """A bare ``upper_bound`` name crashes the JAX agent's first plan; the
    port reads it as ``{"type": name}`` and plans as JAX does given that."""
    from rl_agents_torch.factory import load_agent as torch_load_agent
    from rl_agents_torch.factory import load_agent_config
    from rl_agents_torch.factory import load_environment as torch_load_environment
    from rl_agents_tpu.factory import load_agent as jax_load_agent
    from rl_agents_tpu.factory import load_environment as jax_load_environment

    config = load_agent_config(CONFIGS / relpath)
    assert isinstance(config["upper_bound"], str)
    env_path = CONFIGS / "FiniteMDPEnv" / "env_loop.json"
    env_j = jax_load_environment(env_path)
    obs_j, _ = env_j.reset(seed=0)
    with pytest.raises(AttributeError, match="'str' object has no attribute 'get'"):
        jax_load_agent(dict(config), env_j).plan(obs_j)

    env_t = torch_load_environment(env_path, device="cpu")
    obs_t, _ = env_t.reset(seed=0)
    agent_t = torch_load_agent(dict(config), env_t, device="cpu")
    agent_j = jax_load_agent(dict(config, upper_bound={"type": config["upper_bound"]}), env_j)
    for _ in range(3):
        plan_j, plan_t = agent_j.plan(obs_j), agent_t.plan(obs_t)
        assert [int(a) for a in plan_t] == [int(a) for a in plan_j]
        obs_j, reward_j, *_ = env_j.step(plan_j[0])
        obs_t, reward_t, *_ = env_t.step(plan_t[0])
        assert int(obs_t) == int(obs_j) and reward_t == reward_j
