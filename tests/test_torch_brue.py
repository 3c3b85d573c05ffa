"""BRUE of the PyTorch port against the JAX package.

``brue_plan`` is fed the draws that ``jax.vmap(brue_plan)`` makes from each
tree's key. The JAX planner's chain splits one subkey per episode for the
rollout and one per live update for the estimate
(rl_agents_tpu/agents/tree_search/brue.py:163, 207, 225), and draws the
root's tie-break from what is left of the chain (:240): the test rebuilds,
for every position i of the chain, the draws that subkey i would give either
way, and the port takes them in order. The chosen actions and every integer
arena field (counts, children, observation keys, depths) are equal; rewards
and values agree within 1e-6. The cases are stochastic: Sailing and a sparse
garnet MDP, with budgets that end episodes early and leave idle ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import batch as tbatch
from rl_agents_torch.agents.tree_search.brue import BRUENoise
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_tpu.agents.tree_search import batch as jbatch
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing

torch.set_num_threads(1)

B = 6
ATOL = 1e-6
INT_FIELDS = ("d_count", "d_children", "d_depth", "c_count", "c_child_keys", "c_children",
              "c_n_children", "d_used", "c_used")
FLOAT_FIELDS = ("d_reward", "c_value")


def _garnet_case():
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(1), 12, 3, branching=3)
    s = np.random.default_rng(0).integers(0, 12, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    env_draw = lambda ks: jax.random.gumbel(ks, (3,), jnp.float32)
    return (env_j, params_j, states), (torch_mdp.FiniteMDPEnv(12, 3, mode="sparse"), params_t,
                                       torch_mdp.MDPState), env_draw, 3


def _sailing_case():
    size = 5
    env_j = jax_sailing.SailingEnv(size=size, max_episode_steps=100)
    rng = np.random.default_rng(4)
    states = jax_sailing.SailingState(
        pos=rng.integers(0, size - 1, (B, 2)).astype(np.int32),
        wind=rng.integers(0, 8, B).astype(np.int32), t=np.zeros(B, np.int32))
    env_t = torch_sailing.SailingEnv(size=size, max_episode_steps=100)
    env_draw = lambda ks: jax.random.uniform(jax.random.split(ks)[0])
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_sailing.SailingState), env_draw, 8


CASES = {"sailing": _sailing_case, "garnet": _garnet_case}


def _draws(keys, length, horizon, num_actions, width, env_draw):
    """``BRUENoise`` ``[I, B, ...]`` for the first ``length`` subkeys of each
    tree's chain."""
    def rollout_draws(sub):
        def body(k, _):
            k, ka, ks = jax.random.split(k, 3)
            return k, (jax.random.randint(ka, (), 0, num_actions), env_draw(ks))
        return jax.lax.scan(body, sub, None, length=horizon)[1]

    def estimate_draws(sub):
        def body(k, _):
            k, ks = jax.random.split(k)
            return k, jax.random.gumbel(ks, (width,), jnp.float32)
        return jax.lax.scan(body, sub, None, length=horizon)[1]

    def position(key, _):
        final = jax.random.gumbel(key, (num_actions,), jnp.float32)
        key, sub = jax.random.split(key)
        actions, env = rollout_draws(sub)
        return key, (actions, env, estimate_draws(sub), final)

    def per_tree(key):
        return jax.lax.scan(position, key, None, length=length)[1]

    actions, env, estimate, final = (np.swapaxes(np.asarray(x), 0, 1)
                                     for x in jax.jit(jax.vmap(per_tree))(keys))
    return BRUENoise(rollout_actions=actions, rollout_env=env, estimate=estimate, final=final)


@pytest.mark.parametrize("name,budget,horizon,width", [("sailing", 20, 4, 3),
                                                       ("garnet", 24, 5, 2)])
def test_plans_match_jax(name, budget, horizon, width):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), env_draw, A = CASES[name]()
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    plan = dict(num_actions=A, budget=budget, horizon=horizon, gamma=0.9, width=width)
    action_j, tree_j = jbatch.brue_plan_batch(env_j, params_j,
                                              jax.tree.map(jnp.asarray, states_j), keys, **plan)
    noise = _draws(keys, budget * (1 + horizon) + 1, horizon, A, width, env_draw)
    action_t, tree_t = tbatch.brue_plan_batch(
        env_t, params_t, from_numpy(state_cls, states_j, device="cpu"), None, noise=noise,
        device="cpu", **plan)
    np.testing.assert_array_equal(action_t.numpy(), np.asarray(action_j))
    got = tree_to_numpy(tree_t)
    for field in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(tree_j, field)).astype(np.int64),
                                      err_msg=field)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                   atol=ATOL, err_msg=field)
    assert got.c_n_children.max() >= 2  # outcomes were told apart
    assert got.d_count[:, 1:].max() >= 2  # and revisited


def test_agent_on_the_corpus_config():
    """``SailingEnv/agents/brue.json`` (budget 200, gamma 0.99) sizes its
    horizon by the OLOP allocation; three steps on a small Sailing grid."""
    env = torch_factory.load_environment({"id": "sailing-v0", "size": 5}, device="cpu")
    agent = torch_factory.load_agent("scripts/configs/SailingEnv/agents/brue.json", env,
                                     device="cpu")
    assert (agent.config["episodes"], agent.config["horizon"]) == (3, 55)
    obs, _ = env.reset(seed=0)
    for _ in range(3):
        action = agent.act(obs)
        assert 0 <= action < 8
        obs, *_ = env.step(action)
    tree = agent.last_plan_data
    assert int(tree.c_count[0].sum()) > 0
