"""MCTS with a prior policy in the PyTorch port against the JAX package.

The batch planner ``mcts_prior_plan`` is fed the Gumbel draws that
``jax.vmap(mcts_prior_plan)`` makes from each tree's key, rebuilt here by
replaying the key chain. Actions, lengths and the integer arena fields are
equal; ``value`` and ``prior`` agree within 1e-5. Three priors: a DQN's
Boltzmann distribution from converted flax weights (CartPole and highway),
a tabular per-node prior on a finite MDP, and the root-state prior on
highway's time-to-collision view (``vi_prior.json``). Then the agent: the
unnormalized prior rows of the JAX package, and the chain save ->
``model_save`` -> plan."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import mcts_with_prior as tp
from rl_agents_torch.convert import (
    flax_params_to_torch,
    from_numpy,
    highway_state_from_numpy,
    tree_to_numpy,
)
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import highway as th
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.models.zoo import model_factory
from rl_agents_tpu.agents.tree_search import mcts_with_prior as jp
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import highway as jh
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.models.zoo import model_factory as jax_model_factory

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
PRIOR_CONFIGS = CONFIGS / "HighwayEnv" / "agents" / "MCTSWithPriorPolicyAgent"
B = 4
ATOL = 1e-5


def _tree_draws(key, episodes, horizon, num_actions):
    """The Gumbel draws of one tree's ``mcts_prior_plan``
    (rl_agents_tpu/.../mcts_with_prior.py:44,58,86): per episode the key
    splits three ways, and every descent step and rollout step splits its
    chain three ways and draws ``gumbel(ka)``. ``(descend, rollout)``, each
    ``[episodes, horizon, A]``."""
    descend, rollout = [], []
    for _ in range(episodes):
        key, kdesc, kroll = jax.random.split(key, 3)
        for chain, out in ((kdesc, descend), (kroll, rollout)):
            row = []
            for _ in range(horizon):
                chain, ka, _ = jax.random.split(chain, 3)
                row.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
            out.append(jnp.stack(row))
    return jnp.stack(descend), jnp.stack(rollout)


def _draws(keys, plan):
    """``(descend, rollout)`` as the port takes them, ``[episodes, H, B, A]``."""
    fn = jax.jit(jax.vmap(lambda k: _tree_draws(k, plan["episodes"], plan["horizon"],
                                                plan["num_actions"])))
    return tuple(np.transpose(np.asarray(d), (1, 2, 0, 3)) for d in fn(keys))


def _jax_plan(env_j, params_j, states_j, obs_j, keys, prior_params, prior_fn, plan):
    def one(state, obs, key):
        return jp.mcts_prior_plan(env_j, params_j, state, obs, key, prior_params, prior_fn,
                                  **plan)
    return jax.vmap(one)(states_j, obs_j, keys)


def _assert_plans_equal(got, want):
    actions_t, lengths_t, tree_t = got
    actions_j, lengths_j, tree_j = want
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    tree_t = tree_to_numpy(tree_t)
    for name in ("parent", "children", "count", "used"):
        np.testing.assert_array_equal(getattr(tree_t, name), np.asarray(getattr(tree_j, name)),
                                      err_msg=name)
    for name in ("value", "prior"):
        np.testing.assert_allclose(getattr(tree_t, name), np.asarray(getattr(tree_j, name)),
                                   atol=ATOL, err_msg=name)


def _dqn_priors(layers, obs_dim, num_actions, temperature, seed):
    """One MLP Q-network in both packages with the same (flax-initialised)
    weights, and each package's Boltzmann prior over it."""
    config = {"type": "MultiLayerPerceptron", "layers": list(layers), "out": num_actions}
    model_j = jax_model_factory(dict(config))
    params_j = model_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    model_t = model_factory(dict(config), (obs_dim,))
    flax_params_to_torch(model_t, jax.tree.map(np.asarray, params_j))
    params_t = {k: v.detach().clone() for k, v in model_t.named_parameters()}

    def prior_j(params, obs):  # as MCTSWithPriorPolicyAgent.make_planner writes it
        q = model_j.apply(params, jnp.ravel(jnp.asarray(obs, jnp.float32))[None, :obs_dim])
        return jax.nn.softmax(q[0] / temperature)

    return (params_j, prior_j), (params_t, tp.dqn_prior(model_t, temperature, obs_dim))


@pytest.mark.parametrize("temperature", [0.5, 0.3])
def test_dqn_prior_plan_on_cartpole_matches_jax(temperature):
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    v[2] *= 3.5
    states_j = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    states_j = jax.tree.map(jnp.asarray, states_j)
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_j)
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=200)
    params_t = from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu")
    states_t = from_numpy(torch_cartpole.CartPoleState, states_j, device="cpu")
    (pp_j, prior_j), (pp_t, prior_t) = _dqn_priors((16, 16), 4, 2, temperature, seed=3)
    plan = dict(num_actions=2, episodes=10, horizon=6, gamma=0.95, temperature=40.0)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = _jax_plan(env_j, params_j, states_j, obs_j, keys, pp_j, prior_j, plan)
    noise = _draws(keys, plan)
    calls = []

    def counted_prior(params, obs):
        calls.append(obs.shape[0])
        return prior_t(params, obs)

    assert tp.mcts_prior_plan_batch is tp.mcts_prior_plan_batch_vmap is tp.mcts_prior_plan
    got = tp.mcts_prior_plan_batch(env_t, params_t, states_t, torch.tensor(np.asarray(obs_j)),
                                   None, pp_t, counted_prior, noise=noise, device="cpu", **plan)
    _assert_plans_equal(got, want)
    # one forward on all B trees at each expansion and each rollout step
    assert calls == [B] * (plan["episodes"] * (plan["horizon"] + 1))
    assert tp.mcts_prior_plan.prior_forwards == len(calls)
    # the priors are the network's, not uniform
    assert not np.allclose(got[2].prior[:, 1:].numpy(), 0.5)


def test_dqn_prior_plan_on_highway_matches_jax():
    """``baseline.json``'s prior shape ([512, 512], temperature 0.5) on
    highway's kinematics, cut to 5 vehicles."""
    config = {"vehicles_count": 5, "lanes_count": 3, "duration": 20}
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    env_j, params_j = handle_j.functional, handle_j.params
    keys0 = jax.random.split(jax.random.PRNGKey(21), B)
    states_j, obs_j = jax.vmap(env_j.reset, in_axes=(None, 0))(params_j, keys0)
    states_t = highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")
    obs_dim = int(np.prod(obs_j.shape[1:]))
    (pp_j, prior_j), (pp_t, prior_t) = _dqn_priors((512, 512), obs_dim, 5, 0.5, seed=4)
    plan = dict(num_actions=5, episodes=4, horizon=3, gamma=0.8, temperature=10.0)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    want = _jax_plan(env_j, params_j, states_j, obs_j, keys, pp_j, prior_j, plan)
    got = tp.mcts_prior_plan(handle_t.functional, handle_t.params, states_t,
                             torch.tensor(np.asarray(obs_j)), None, pp_t, prior_t,
                             noise=_draws(keys, plan), device="cpu", **plan)
    _assert_plans_equal(got, want)


def test_tabular_prior_plan_on_a_finite_mdp_matches_jax():
    """A per-state Boltzmann table read at every node, as the agent builds it
    for index observations."""
    rng = np.random.default_rng(7)
    S, A = 6, 3
    config = {"mode": "deterministic", "transition": rng.integers(0, S, (S, A)).tolist(),
              "reward": rng.random((S, A)).round(3).tolist(), "terminal": [0, 0, 0, 0, 0, 1],
              "max_episode_steps": 50}
    env_j, params_j = jax_mdp.params_from_config(config)
    env_t, params_t = torch_mdp.params_from_config(config, device="cpu")
    s = np.array([0, 1, 2, 3], np.int32)
    states_j = jax_mdp.MDPState(s=jnp.asarray(s), t=jnp.zeros(B, jnp.int32),
                                done=jnp.zeros(B, bool))
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_j)
    table = jp.MCTSWithPriorPolicyAgent._boltzmann_rows(rng.normal(size=(S, A)), 0.5)

    def prior_fn_j(tab, obs):  # rl_agents_tpu/.../mcts_with_prior.py:176-179
        oh = jnp.arange(tab.shape[0]) == jnp.asarray(obs, jnp.int32)
        return jnp.sum(jnp.where(oh[:, None], tab, 0.0), axis=0)

    plan = dict(num_actions=A, episodes=12, horizon=4, gamma=0.9, temperature=5.0)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    want = _jax_plan(env_j, params_j, states_j, obs_j, keys, jnp.asarray(table), prior_fn_j, plan)
    got = tp.mcts_prior_plan(env_t, params_t, from_numpy(torch_mdp.MDPState, states_j, "cpu"),
                             torch.tensor(np.asarray(obs_j)), None, torch.tensor(table),
                             tp.tabular_prior, noise=_draws(keys, plan), device="cpu", **plan)
    _assert_plans_equal(got, want)
    # an expansion at state s writes the table's row of s
    tree = tree_to_numpy(got[2])
    np.testing.assert_array_equal(tree.prior[:, 1:1 + A], table[s])


def _synced_highway(config):
    """A highway handle in each package, the port's state set to JAX's."""
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    handle_j.reset(seed=3)
    state = jax.tree.map(lambda x: np.asarray(x)[None], handle_j.state)
    handle_t.state = highway_state_from_numpy(state, device="cpu")
    handle_t.obs = handle_t.functional.observe(handle_t.params, handle_t.state)
    return handle_j, handle_t


def test_vi_root_prior_on_highway_matches_jax():
    """``vi_prior.json``: the ValueIterationAgent prior re-derives highway's
    TTC view at the root and its Boltzmann row is applied at every node. The
    root rows are equal; a plan from it agrees with JAX's under its draws."""
    config = {"vehicles_count": 6, "lanes_count": 3, "duration": 20}
    handle_j, handle_t = _synced_highway(config)
    agent_config = load_agent_config(PRIOR_CONFIGS / "vi_prior.json")
    agent_j = jax_load_agent(dict(agent_config), handle_j)
    agent_t = torch_load_agent(load_agent_config(PRIOR_CONFIGS / "vi_prior.json"), handle_t,
                               device="cpu")
    assert agent_t._tabular_prior and not agent_t._index_obs
    assert agent_t.config["episodes"] == agent_j.config["episodes"]
    for agent in (agent_j, agent_t):
        agent.num_actions = 5
    obs = np.asarray(handle_j.obs)
    agent_j._refresh_root_prior(obs)
    agent_t._refresh_root_prior(obs)
    np.testing.assert_array_equal(agent_t._root_prior.numpy(), np.asarray(agent_j._root_prior))

    env_j, params_j = handle_j.functional, handle_j.params
    keys0 = jax.random.split(jax.random.PRNGKey(2), B)
    states_j, obs_j = jax.vmap(env_j.reset, in_axes=(None, 0))(params_j, keys0)
    plan = dict(num_actions=5, episodes=5, horizon=3, gamma=0.8, temperature=100.0)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    want = _jax_plan(env_j, params_j, states_j, obs_j, keys, agent_j._root_prior,
                     agent_j._prior_fn, plan)
    got = tp.mcts_prior_plan(handle_t.functional, handle_t.params,
                             highway_state_from_numpy(jax.tree.map(np.asarray, states_j), "cpu"),
                             torch.tensor(np.asarray(obs_j)), None, agent_t._root_prior,
                             agent_t._prior_fn, noise=_draws(keys, plan), device="cpu", **plan)
    _assert_plans_equal(got, want)


def test_prior_rows_are_not_renormalized_over_the_planner_actions():
    """The JAX package cuts the prior's Boltzmann rows to the planner's
    actions without renormalizing them (mcts_with_prior.py:225,234); the port
    keeps that. With a 3-action prior and a 2-action planner the rows sum to
    less than one, equally in both."""
    config = {"mode": "deterministic", "transition": [[0, 1, 2], [1, 2, 0], [2, 0, 1]],
              "reward": [[0.1, 0.5, 0.9], [0.3, 0.2, 0.8], [0.0, 0.4, 0.6]],
              "terminal": [0, 0, 0], "max_episode_steps": 20}
    agent_config = {"__class__": "MCTSWithPriorPolicyAgent", "budget": 20,
                    "prior_agent": {"__class__": "ValueIterationAgent", "gamma": 0.9,
                                    "exploration": {"temperature": 0.5}}}
    handle_j = jax_mdp.make(dict(config))
    handle_t = torch_mdp.make(dict(config), device="cpu")
    agent_j = jax_load_agent(json.loads(json.dumps(agent_config)), handle_j)
    agent_t = torch_load_agent(json.loads(json.dumps(agent_config)), handle_t, device="cpu")
    assert agent_t._index_obs
    for agent in (agent_j, agent_t):
        agent.num_actions = 2
    agent_j._refresh_root_prior(0)
    agent_t._refresh_root_prior(0)
    got, want = agent_t._root_prior.numpy(), np.asarray(agent_j._root_prior)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 2) and (got.sum(axis=1) < 1 - 1e-3).all()
    # a plan refreshes the table at the planning env's 3 actions
    assert agent_t.plan(0)[0] in (0, 1, 2)
    assert agent_t._root_prior.shape == (3, 3)


def test_baseline_config_plans_with_a_saved_dqn_prior(tmp_path, monkeypatch):
    """The chain of ``tests/test_mcts_prior_artifact_chain.py`` in the port:
    a ``[512, 512]`` DQN saved with ``DQNAgent.save`` at the path that
    ``baseline.json``'s ``model_save`` names is loaded by the agent, whose
    prior is then that network's."""
    handle = th.make({"vehicles_count": 5, "lanes_count": 3, "duration": 6}, device="cpu")
    config = load_agent_config(PRIOR_CONFIGS / "baseline.json")
    prior_config = dict(config["prior_agent"])
    artifact = tmp_path / prior_config.pop("model_save")
    prior = torch_load_agent(prior_config, handle, device="cpu")
    prior.save(artifact)
    monkeypatch.chdir(tmp_path)
    config["budget"] = 24
    agent = torch_load_agent(config, handle, device="cpu")
    assert not agent._tabular_prior
    for key, value in prior.train_state.params.items():
        assert torch.equal(agent.prior_agent.train_state.params[key], value)
    obs, _ = handle.reset(seed=0)
    plan = agent.plan(obs)
    assert plan and all(a in range(5) for a in plan)
    tree = tree_to_numpy(agent.last_plan_data)
    x = torch.as_tensor(obs, dtype=torch.float32).reshape(1, -1)
    with torch.no_grad():
        q = prior.get_batch_state_action_values(x.numpy())
    root_probs = torch.softmax(torch.tensor(q) * 2.0, dim=-1).numpy()[0]
    np.testing.assert_allclose(tree.prior[0, 1:6], root_probs, atol=1e-6)
    assert agent.save(tmp_path / "again.tar")


# ---- the root vector of a prior agent without a Q table, and env draws ----

SIX_STATES = {"mode": "deterministic",
              "transition": [[1, 2, 3], [2, 3, 4], [3, 4, 5], [4, 5, 0], [5, 0, 1], [0, 1, 2]],
              "reward": [[0.1, 0.5, 0.2], [0.3, 0.0, 0.8], [0.6, 0.4, 0.1], [0.2, 0.9, 0.3],
                         [0.7, 0.1, 0.5], [0.0, 0.3, 0.6]],
              "terminal": [0, 0, 0, 0, 0, 0], "max_episode_steps": 50}


def _env_draw_chain(key, episodes, horizon, num_actions, draw):
    """``_tree_draws`` with the env's draw ``draw(ks)`` of every descent and
    rollout step (rl_agents_tpu/.../mcts_with_prior.py:58-60,86-88):
    ``(descend, rollout, env_descend, env_rollout)``."""
    out = ([], [], [], [])
    for _ in range(episodes):
        key, kdesc, kroll = jax.random.split(key, 3)
        for chain, g_out, env_out in ((kdesc, out[0], out[2]), (kroll, out[1], out[3])):
            g_row, env_row = [], []
            for _ in range(horizon):
                chain, ka, ks = jax.random.split(chain, 3)
                g_row.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
                env_row.append(draw(ks))
            g_out.append(jnp.stack(g_row))
            env_out.append(jnp.stack(env_row))
    return tuple(jnp.stack(x) for x in out)


def _draws_with_env(keys, plan, draw):
    """``(noise, env_noise)`` as the port takes them, each a pair of
    ``[episodes, H, B, ...]``."""
    fn = jax.jit(jax.vmap(lambda k: _env_draw_chain(k, plan["episodes"], plan["horizon"],
                                                     plan["num_actions"], draw)))
    d, r, ed, er = (np.moveaxis(np.asarray(x), 0, 2) for x in fn(keys))
    return (d, r), (ed, er)


def test_root_vector_prior_of_an_agent_plans_as_jax():
    """A ``RandomUniformAgent`` prior has no Q table, so the agent's root
    prior is a vector ``[A]``: 0.9 on the prior's action. JAX's ``prior_fn``
    gives the whole vector at a state index below A and zeros at A or above
    (a latent defect of the JAX package that the port keeps); trees at
    states 1, 2, 4 and 5 plan as ``jax.vmap(mcts_prior_plan)``'s under its
    draws."""
    agent_config = {"__class__": "MCTSWithPriorPolicyAgent", "budget": 20,
                    "prior_agent": {"__class__": "RandomUniformAgent"}}
    handle_j = jax_mdp.make(dict(SIX_STATES))
    handle_t = torch_mdp.make(dict(SIX_STATES), device="cpu")
    agent_j = jax_load_agent(json.loads(json.dumps(agent_config)), handle_j)
    agent_t = torch_load_agent(json.loads(json.dumps(agent_config)), handle_t, device="cpu")
    assert agent_t._tabular_prior and agent_t._index_obs
    for agent in (agent_j, agent_t):
        agent.num_actions = 3
        agent.seed(4)
        agent._refresh_root_prior(1)
    root = agent_t._root_prior.numpy()
    np.testing.assert_array_equal(root, np.asarray(agent_j._root_prior))
    assert root.shape == (3,) and sorted(root.tolist()) == pytest.approx([0.05, 0.05, 0.9])

    s = np.array([1, 2, 4, 5], np.int32)
    obs = torch.tensor(s)
    want_rows = np.asarray(jax.vmap(lambda o: agent_j._prior_fn(agent_j._root_prior, o))(s))
    np.testing.assert_array_equal(agent_t._prior_fn(agent_t._root_prior, obs).numpy(), want_rows)
    np.testing.assert_array_equal(want_rows, [root, root, [0, 0, 0], [0, 0, 0]])

    env_j, params_j = handle_j.functional, handle_j.params
    states_j = jax_mdp.MDPState(s=jnp.asarray(s), t=jnp.zeros(B, jnp.int32),
                                done=jnp.zeros(B, bool))
    plan = dict(num_actions=3, episodes=10, horizon=4, gamma=0.9, temperature=5.0)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = _jax_plan(env_j, params_j, states_j, jnp.asarray(s), keys, agent_j._root_prior,
                     agent_j._prior_fn, plan)
    got = tp.mcts_prior_plan(handle_t.functional, handle_t.params,
                             from_numpy(torch_mdp.MDPState, states_j, "cpu"), obs, None,
                             agent_t._root_prior, agent_t._prior_fn, noise=_draws(keys, plan),
                             device="cpu", **plan)
    _assert_plans_equal(got, want)
    tree = tree_to_numpy(got[2])
    np.testing.assert_array_equal(tree.prior[:, 1:4], want_rows)  # the root expansions


@pytest.mark.parametrize("table", ["rows", "root_vector"])
def test_prior_plan_on_a_stochastic_garnet_matches_with_jax_env_keys(table):
    """JAX's garnet of branching 2, carried across, under a per-state table
    ``[S, A]`` and under a root vector ``[A]``: with the tie-breaking,
    rollout and next-state draws of each tree's key injected, the plans are
    JAX's."""
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=2)
    env_t = torch_mdp.FiniteMDPEnv(16, 4, mode=env_j.mode,
                                   max_episode_steps=env_j.max_episode_steps)
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(11)
    s = np.array([0, 3, 7, 12], np.int32)
    states_j = jax_mdp.MDPState(s=jnp.asarray(s), t=jnp.zeros(B, jnp.int32),
                                done=jnp.zeros(B, bool))
    rows = jp.MCTSWithPriorPolicyAgent._boltzmann_rows(rng.normal(size=(16, 4)), 0.5)
    prior = rows if table == "rows" else rows[5]

    def prior_fn_j(tab, obs):  # rl_agents_tpu/.../mcts_with_prior.py:176-179
        oh = jnp.arange(tab.shape[0]) == jnp.asarray(obs, jnp.int32)
        return jnp.sum(jnp.where(oh[:, None], tab, 0.0), axis=0)

    plan = dict(num_actions=4, episodes=10, horizon=4, gamma=0.8, temperature=5.0)
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    want = _jax_plan(env_j, params_j, states_j, jnp.asarray(s), keys, jnp.asarray(prior),
                     prior_fn_j, plan)
    noise, env_noise = _draws_with_env(keys, plan,
                                       lambda k: jax.random.gumbel(k, (2,), jnp.float32))
    got = tp.mcts_prior_plan(env_t, params_t, from_numpy(torch_mdp.MDPState, states_j, "cpu"),
                             torch.tensor(s), None, torch.tensor(prior), tp.tabular_prior,
                             noise=noise, env_noise=env_noise, device="cpu", **plan)
    _assert_plans_equal(got, want)
