"""The port's env-generic planners on the highway surrogate at full width
(15 vehicles on 4 lanes, ``scripts/configs/HighwayEnv/env.json``) against
``jax.vmap`` of the JAX package's planners, under JAX's own draws rebuilt
from its keys: MCTS, OPD (vmapped and fused batch), GBOP-D, stochastic GBOP
and KL-OLOP.

Actions, lengths and every integer arena field are equal; bounds agree within
1e-5 and are bit-equal where the port's ``fma`` makes them so (the highway
dynamics are deterministic: ``null_noise`` is None and no env draw is made).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gbop import _jax_noise as gbop_d_draws
from test_torch_gbop_stochastic import _jax_draws as gbop_draws
from test_torch_mcts import _draws as mcts_draws
from test_torch_olop import _jax_continuation_draws as olop_draws
from test_torch_opd import _chain_noise, _fused_noise

from rl_agents_torch.agents.tree_search import batch as tb
from rl_agents_torch.agents.tree_search import deterministic as td
from rl_agents_torch.agents.tree_search import mcts as tm
from rl_agents_torch.convert import highway_state_from_numpy, tree_to_numpy
from rl_agents_torch.envs import highway as th
from rl_agents_tpu.agents.tree_search import batch as jb
from rl_agents_tpu.agents.tree_search import deterministic as jd
from rl_agents_tpu.agents.tree_search import mcts as jm
from rl_agents_tpu.envs import highway as jh

torch.set_num_threads(1)

B = 4
ATOL = 1e-5
A = 5


@pytest.fixture(scope="module")
def highway():
    """The env of ``HighwayEnv/env.json`` in both packages and ``B`` start
    states drawn by JAX's ``reset``."""
    config = {"vehicles_count": 15, "lanes_count": 4, "duration": 40}
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    env_j, params_j = handle_j.functional, handle_j.params
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    states_j, obs_j = jax.vmap(env_j.reset, in_axes=(None, 0))(params_j, keys)
    states_t = highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")
    return (env_j, params_j, states_j, obs_j), (handle_t.functional, handle_t.params, states_t)


def _assert_fields(tree_t, tree_j, exact, close):
    got = tree_to_numpy(tree_t)
    for field in exact:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                      err_msg=field)
    for field in close:
        want = np.asarray(getattr(tree_j, field))
        np.testing.assert_array_equal(np.isinf(getattr(got, field)), np.isinf(want), err_msg=field)
        finite = np.isfinite(want)
        np.testing.assert_allclose(getattr(got, field)[finite], want[finite], atol=ATOL,
                                   err_msg=field)


def test_highway_transition_draws_nothing(highway):
    _, (env_t, params_t, states_t) = highway
    assert env_t.null_noise(3, "cpu") is None and not env_t.transition_uses_key
    out = env_t.transition(params_t, states_t, torch.full((B,), 3), None, None)
    again = env_t.step(params_t, states_t, torch.full((B,), 3), torch.Generator(), "ignored")
    for a, b in zip(out.state, again.state):
        assert torch.equal(a, b)
    assert again.obs.shape == (B, 15, 5)


def test_mcts_plan_matches_with_jax_draws(highway):
    (env_j, params_j, states_j, _), (env_t, params_t, states_t) = highway
    plan = dict(num_actions=A, episodes=5, horizon=4, gamma=0.95, temperature=40.0)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    probs_j = jnp.ones(A) / A
    actions_j, lengths_j, tree_j = jm.mcts_plan_batch_vmap(env_j, params_j, states_j, keys,
                                                           probs_j, probs_j, **plan)
    descend, rollout, _ = mcts_draws(keys, plan)
    probs_t = torch.ones(A) / A
    actions_t, lengths_t, tree_t = tm.mcts_plan(env_t, params_t, states_t, None, probs_t, probs_t,
                                                noise=(descend, rollout), device="cpu", **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    _assert_fields(tree_t, tree_j, ("parent", "children", "count", "used"), ("value", "prior"))
    # highway rewards are fractions: the values are bit-equal too
    np.testing.assert_array_equal(tree_t.value.numpy(), np.asarray(tree_j.value))


OPD_EXACT = ("parent", "action", "depth", "children", "done", "leaf", "count", "used")
OPD_BOUNDS = ("reward", "value_lower", "value_upper")


def test_opd_plan_and_fused_batch_match_jax(highway):
    (env_j, params_j, states_j, _), (env_t, params_t, states_t) = highway
    plan = dict(num_actions=A, expansions=6, gamma=0.9, plan_capacity=6)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    out_j = jax.vmap(lambda s, k: jd.opd_plan(env_j, params_j, s, k, **plan))(states_j, keys)
    out_t = td.opd_plan(env_t, params_t, states_t, None,
                        noise=_chain_noise(keys, plan["plan_capacity"], A), device="cpu", **plan)
    fused_j = jd.opd_plan_batch(env_j, params_j, states_j, keys, **plan)
    fused_t = tb.opd_plan_batch(env_t, params_t, states_t, None,
                                noise=_fused_noise(keys, plan["plan_capacity"], A), device="cpu",
                                **plan)
    for (actions_j, lengths_j, tree_j), (actions_t, lengths_t, tree_t) in (
            (out_j, out_t), (fused_j, fused_t)):
        np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
        _assert_fields(tree_t, tree_j, OPD_EXACT, OPD_BOUNDS)
        for field in OPD_BOUNDS:
            np.testing.assert_array_equal(getattr(tree_t, field).numpy(),
                                          np.asarray(getattr(tree_j, field)), err_msg=field)
        # the arena's highway states, bit for bit
        allocated = np.asarray(tree_j.parent) >= 0
        allocated[:, 0] = True
        for arena_t, arena_j in zip(tree_t.states, tree_j.states):
            np.testing.assert_array_equal(arena_t.numpy()[allocated],
                                          np.asarray(arena_j)[allocated])


def test_gbop_d_plan_matches_with_jax_draws(highway):
    (env_j, params_j, states_j, obs_j), (env_t, params_t, states_t) = highway
    from rl_agents_tpu.agents.tree_search import graph_based as jgb

    plan = dict(num_actions=A, expansions=4, gamma=0.9, accuracy=1e-2)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    actions_j, lengths_j, graph_j = jax.vmap(
        lambda s, o, k: jgb.gbop_plan(env_j, params_j, s, o, k, **plan))(states_j, obs_j, keys)
    obs_t = env_t.observe(params_t, states_t)
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    actions_t, lengths_t, graph_t = tb.gbop_plan_batch(
        env_t, params_t, states_t, obs_t, noise=gbop_d_draws(keys, A, plan["expansions"]),
        device="cpu", **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    _assert_fields(graph_t, graph_j, ("keys", "expanded", "children", "used"),
                   ("rewards", "value_lower", "value_upper"))
    # the 15 x 5 observations hash to the same node keys: new nodes were found
    assert (np.asarray(graph_j.used) > 1 + A).all()


def test_stochastic_gbop_plan_matches_with_jax_draws(highway):
    (env_j, params_j, states_j, obs_j), (env_t, params_t, states_t) = highway
    from rl_agents_tpu.agents.tree_search import graph_based_stochastic as jgs

    plan = dict(num_actions=A, episodes=4, horizon=3, gamma=0.9, accuracy=1e-2,
                reward_threshold_coeff=2.0, transition_threshold_coeff=2.0)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    action_j, graph_j = jax.vmap(
        lambda s, o, k: jgs.gbop_stochastic_plan(env_j, params_j, s, o, k, **plan))(
        states_j, obs_j, keys)
    noise, _ = gbop_draws(keys, plan["episodes"], plan["horizon"], A,
                          lambda ks: jnp.zeros((), jnp.float32))
    action_t, graph_t = tb.gbop_stochastic_plan_batch(
        env_t, params_t, states_t, env_t.observe(params_t, states_t), noise=noise,
        device="cpu", **plan)
    np.testing.assert_array_equal(action_t.numpy(), np.asarray(action_j))
    _assert_fields(graph_t, graph_j,
                   ("visited", "n_count", "c_count", "sa_count", "sa_keys", "sa_child", "sa_n",
                    "used"),
                   ("sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "value_lower", "value_upper"))


@pytest.mark.parametrize("continuation_uniform", [False, True])
def test_kl_olop_plan_matches_jax(highway, continuation_uniform):
    """At ``HighwayEnv/agents/OLOPAgent/kl-olop.json``'s gamma 0.7 and its
    ``2*np.log(time)`` threshold, with its uniform continuation and without."""
    (env_j, params_j, states_j, _), (env_t, params_t, states_t) = highway
    plan = dict(num_actions=A, episodes=8, horizon=3, gamma=0.7, threshold_coeff=2.0,
                continuation_uniform=continuation_uniform)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    actions_j, lengths_j, tree_j = jb.olop_plan_batch(env_j, params_j, states_j, keys, **plan)
    draws = olop_draws(keys, plan["episodes"], plan["horizon"], A) if continuation_uniform \
        else None
    actions_t, lengths_t, tree_t = tb.olop_plan_batch(env_t, params_t, states_t,
                                                      random_actions=draws, device="cpu", **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    _assert_fields(tree_t, tree_j, ("parent", "children", "depth", "count", "done", "used"),
                   ("cum_reward", "mu_ucb", "value_upper"))
