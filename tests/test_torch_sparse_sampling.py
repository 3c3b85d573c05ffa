"""Sparse sampling of the PyTorch port against the JAX package.

``sparse_sampling_plan`` is fed the env draws that ``jax.vmap`` of the JAX
planner makes from each tree's key: level d splits its subkey into
``n * A * C`` keys laid out ``[n, A, C]`` (rl_agents_tpu/agents/tree_search/
sparse_sampling.py:43-44). The chosen actions are equal and the root Q values
agree within 1e-6, on a stochastic garnet (sparse mode), on Sailing and on
the deterministic loop MDP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import batch as tbatch
from rl_agents_torch.convert import from_numpy
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_tpu.agents.tree_search import batch as jbatch
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing

torch.set_num_threads(1)

B = 6
ATOL = 1e-6
LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]], "terminal": [0, 0, 0, 1]}


def _garnet_case():
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(3), 16, 4, branching=2)
    s = np.random.default_rng(0).integers(0, 16, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    env_draw = lambda k: jax.random.gumbel(k, (2,), jnp.float32)
    return (env_j, params_j, states), (torch_mdp.FiniteMDPEnv(16, 4, mode="sparse"), params_t,
                                       torch_mdp.MDPState), env_draw, dict(num_actions=4,
                                                                           horizon=3, samples=2)


def _sailing_case():
    env_j = jax_sailing.SailingEnv(size=5, max_episode_steps=100)
    rng = np.random.default_rng(4)
    states = jax_sailing.SailingState(pos=rng.integers(0, 4, (B, 2)).astype(np.int32),
                                      wind=rng.integers(0, 8, B).astype(np.int32),
                                      t=np.zeros(B, np.int32))
    env_t = torch_sailing.SailingEnv(size=5, max_episode_steps=100)
    env_draw = lambda k: jax.random.uniform(jax.random.split(k)[0])
    return (env_j, env_j.default_params(), states), (env_t, env_t.default_params("cpu"),
                                                     torch_sailing.SailingState), env_draw, \
        dict(num_actions=8, horizon=2, samples=3)


def _loop_case():
    env_j, params_j = jax_mdp.params_from_config(LOOP)
    env_t, params_t = torch_mdp.params_from_config(LOOP, device="cpu")
    states = jax_mdp.MDPState(s=np.array([0, 1, 2, 3, 0, 2], np.int32), t=np.zeros(B, np.int32),
                              done=np.zeros(B, bool))
    return (env_j, params_j, states), (env_t, params_t, torch_mdp.MDPState), None, \
        dict(num_actions=3, horizon=4, samples=2)


CASES = {"garnet": _garnet_case, "sailing": _sailing_case, "loop": _loop_case}


def _level_draws(keys, plan, env_draw):
    """The env draws of every level, ``[B, n, A, C, ...]`` (each tree's key
    splits once per level, then into ``n * A * C`` keys)."""
    A, C, H = plan["num_actions"], plan["samples"], plan["horizon"]

    def per_tree(key):
        levels = []
        for d in range(H):
            n = (A * C) ** d
            key, sub = jax.random.split(key)
            ks = jax.random.split(sub, n * A * C)
            draw = jax.vmap(env_draw)(ks)
            levels.append(draw.reshape((n, A, C) + draw.shape[1:]))
        return levels

    return [np.asarray(x) for x in jax.jit(jax.vmap(per_tree))(keys)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_match_jax(name):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), env_draw, plan = CASES[name]()
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    action_j, q_j = jbatch.sparse_sampling_plan_batch(
        env_j, params_j, jax.tree.map(jnp.asarray, states_j), keys, gamma=0.7, **plan)
    noise = _level_draws(keys, plan, env_draw) if env_draw else None
    action_t, q_t = tbatch.sparse_sampling_plan_batch(
        env_t, params_t, from_numpy(state_cls, states_j, device="cpu"), None, gamma=0.7,
        noise=noise, device="cpu", **plan)
    np.testing.assert_array_equal(action_t.numpy(), np.asarray(action_j))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=ATOL)
    assert np.ptp(np.asarray(q_j)) > 0.1


def test_agent_on_the_corpus_garnet():
    """``FiniteMDPEnv/agents/sparse_sampling.json`` (C = 3, horizon 3) on
    ``env_garnet.json``: three steps."""
    env = torch_factory.load_environment("scripts/configs/FiniteMDPEnv/env_garnet.json",
                                         device="cpu")
    agent = torch_factory.load_agent("scripts/configs/FiniteMDPEnv/agents/sparse_sampling.json",
                                     env, device="cpu")
    assert agent.config["horizon"] == 3 and agent.config["C"] == 3
    obs, _ = env.reset(seed=0)
    for _ in range(3):
        action = agent.act(obs)
        assert 0 <= action < 4
        assert agent.last_plan_data.shape == (1, 4)
        obs, *_ = env.step(action)
    # without a horizon the agent takes the deepest tree within the budget
    agent = torch_factory.load_agent({"__class__": "SparseSamplingAgent", "budget": 100}, env,
                                     device="cpu")
    assert agent.config["horizon"] == 2
