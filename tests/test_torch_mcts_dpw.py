"""MCTS-DPW and closed-loop MCTS of the PyTorch port against the JAX package.

``mcts_dpw_plan`` and ``mcts_closed_loop_plan`` are fed the draws that
``jax.vmap`` of the JAX planners makes from each tree's key, rebuilt here by
replaying the key chain (rl_agents_tpu/agents/tree_search/mcts_dpw.py:84,
120-123, 158-159; mcts_closed_loop.py:99,149-151): the Gumbel draws of the
widened action, the UCB ties and the rollout actions, the random existing
slot for every possible slot count, and the env's own draws. The chosen
actions, every integer arena field (counts, children, observation keys) are
equal, and the values agree within 1e-6. The cases are stochastic: Sailing
and a sparse garnet MDP, plus open-loop DPW on CartPole."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import batch as tbatch
from rl_agents_torch.agents.tree_search.mcts_dpw import DPWNoise, MCTSDPWAgent, widening_table
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_tpu.agents.tree_search import batch as jbatch
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing

torch.set_num_threads(1)

B = 6
ATOL = 1e-6
INT_FIELDS = ("d_parent", "d_count", "d_children", "d_n_children", "c_parent", "c_action",
              "c_count", "c_child_keys", "c_children", "c_n_children", "d_used", "c_used")
FLOAT_FIELDS = ("d_value", "c_value")
DPW = dict(k_action=3.0, alpha_action=0.3, k_state=1.0, alpha_state=0.3)


def _garnet_case():
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=3)
    s = np.random.default_rng(0).integers(0, 16, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_mdp.FiniteMDPEnv(16, 4, mode="sparse")
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    env_draw = lambda ks: jax.random.gumbel(ks, (3,), jnp.float32)
    return (env_j, params_j, states), (env_t, params_t, torch_mdp.MDPState), env_draw, 4


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


def _cartpole_case():
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    v[2] *= 3.5
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=200)
    return (env_j, params_j, states), (
        env_t, from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        torch_cartpole.CartPoleState), None, 2


CASES = {"sailing": _sailing_case, "garnet": _garnet_case, "cartpole": _cartpole_case}


def _draws(keys, episodes, horizon, num_actions, width, env_draw, dpw):
    """Each tree's draws as ``DPWNoise`` arrays ``[E, H, B, ...]``: per
    episode the key splits three ways (descent, rollout); each descent step
    splits ``(k, ka, ks)`` for the expansion and UCB draws (DPW; closed-loop
    MCTS draws only the UCB tie-break from ``ka``), then ``(k, ks)`` for the
    env (DPW) and ``(k, kr)`` for the random slot; each rollout step splits
    ``(k, ka, ks)``."""
    has_env = env_draw is not None
    env_draw = env_draw or (lambda k: jnp.zeros(()))

    def gumbel(k):
        return jax.random.gumbel(k, (num_actions,), jnp.float32)

    def descent_step(k, _):
        k, ka, ks = jax.random.split(k, 3)
        if dpw:
            expand, select = gumbel(ka), gumbel(ks)
            k, ks = jax.random.split(k)
        else:
            expand, select = jnp.zeros(num_actions), gumbel(ka)
        env = env_draw(ks)
        k, kr = jax.random.split(k)
        slot = jnp.stack([jax.random.randint(kr, (), 0, n) for n in range(1, width + 1)])
        return k, (expand, select, env, slot)

    def rollout_step(k, _):
        k, ka, ks = jax.random.split(k, 3)
        return k, (gumbel(ka), env_draw(ks))

    def episode(key, _):
        key, kd, kroll = jax.random.split(key, 3)
        descent = jax.lax.scan(descent_step, kd, None, length=horizon)[1]
        rollout = jax.lax.scan(rollout_step, kroll, None, length=horizon)[1]
        return key, descent + rollout

    def per_tree(key):
        return jax.lax.scan(episode, key, None, length=episodes)[1]

    expand, select, env, slot, rollout, roll_env = (
        np.moveaxis(np.asarray(x), 0, 2) for x in jax.jit(jax.vmap(per_tree))(keys))
    return DPWNoise(expand=expand if dpw else None, select=select, slot=slot,
                    env=env if has_env else None, rollout=rollout,
                    rollout_env=roll_env if has_env else None)


def _assert_trees_match(tree_t, tree_j):
    got = tree_to_numpy(tree_t)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(tree_j, name)).astype(np.int64),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(tree_j, name)),
                                   atol=ATOL, err_msg=name)


def _plan_both(name, closed_loop_mcts, closed_loop=True, episodes=8, horizon=5, width=3):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), env_draw, A = CASES[name]()
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    probs = np.ones(A, np.float32) / A
    plan = dict(num_actions=A, episodes=episodes, horizon=horizon, gamma=0.9, width=width)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    noise = _draws(keys, episodes, horizon, A, width, env_draw, dpw=not closed_loop_mcts)
    if closed_loop_mcts:
        action_j, tree_j = jbatch.mcts_closed_loop_plan_batch(
            env_j, params_j, states_jnp, keys, jnp.asarray(probs), jnp.asarray(probs),
            temperature=4.0, **plan)
        action_t, tree_t = tbatch.mcts_closed_loop_plan_batch(
            env_t, params_t, states_t, None, torch.tensor(probs), torch.tensor(probs),
            temperature=4.0, noise=noise, device="cpu", **plan)
    else:
        action_j, tree_j = jbatch.mcts_dpw_plan_batch(
            env_j, params_j, states_jnp, keys, jnp.asarray(probs), temperature=1.0,
            closed_loop=closed_loop, **DPW, **plan)
        action_t, tree_t = tbatch.mcts_dpw_plan_batch(
            env_t, params_t, states_t, None, torch.tensor(probs), temperature=1.0,
            closed_loop=closed_loop, noise=noise, device="cpu", **DPW, **plan)
    np.testing.assert_array_equal(action_t.numpy(), np.asarray(action_j))
    _assert_trees_match(tree_t, tree_j)
    return tree_to_numpy(tree_t)


@pytest.mark.parametrize("name", ["sailing", "garnet"])
def test_dpw_matches_jax(name):
    tree = _plan_both(name, closed_loop_mcts=False)
    # both widenings happened: several actions and several outcomes per node
    assert tree.d_n_children.max() >= 2
    assert tree.c_n_children.max() >= 2


def test_dpw_open_loop_matches_jax():
    """``closed_loop: false``: one outcome key for every observation, on the
    deterministic CartPole."""
    tree = _plan_both("cartpole", closed_loop_mcts=False, closed_loop=False, episodes=10)
    assert tree.c_n_children.max() == 1
    assert (tree.c_child_keys[tree.c_n_children > 0][:, 0] == 1).all()


@pytest.mark.parametrize("name", ["sailing", "garnet"])
def test_closed_loop_matches_jax(name):
    tree = _plan_both(name, closed_loop_mcts=True, episodes=10)
    assert tree.c_n_children.max() >= 2  # outcomes were told apart


def test_widening_table_matches_xla_pow():
    """``k * n ** alpha`` in float32 as XLA computes it, for every count."""
    n = np.arange(200, dtype=np.float32)
    for k, alpha in ((3.0, 0.3), (1.0, 0.3), (2.0, 0.5), (1.0, 0.25)):
        want = np.asarray(jax.jit(lambda c: jnp.float32(k) * c ** jnp.float32(alpha))(n))
        np.testing.assert_array_equal(widening_table(k, alpha, 200, "cpu").numpy(), want)


def test_dpw_agent_and_corpus_configs_act():
    env = torch_factory.load_environment({"id": "sailing-v0", "size": 5}, device="cpu")
    agent = MCTSDPWAgent(env, {"budget": 30}, device="cpu")
    assert agent.config["temperature"] == 1.0 and agent.config["gamma"] == 0.95
    obs, _ = env.reset(seed=0)
    action = agent.act(obs)
    assert 0 <= action < 8
    tree = agent.last_plan_data
    assert int(tree.d_count[0, 0]) == agent.config["episodes"]
    agent = torch_factory.load_agent({"__class__": "MCTSDPWAgent", "budget": 20}, env, device="cpu")
    assert 0 <= agent.act(obs) < 8
