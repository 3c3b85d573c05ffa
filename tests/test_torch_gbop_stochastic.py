"""Batch-first stochastic GBOP of the PyTorch port against
``jax.vmap(gbop_stochastic_plan)`` of the JAX package.

The planner draws the tie-break of each step's optimistic action, the env's
transition and the tie-break of the final choice at the root; the test
rebuilds all three from each tree's key and injects them. Then the chosen
action and every integer arena field are equal, and the reward sums, the KL
confidence bounds and the value bounds agree within 1e-5. On the CPU the port
computes the KL bounds with ``kl_bound_torch``, the plain version of its CUDA
kernel; the JAX package with ``kl_upper_bound``, the XLA twin of its Pallas
kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import graph_based_stochastic as tgs
from rl_agents_torch.agents.tree_search.batch import (
    gbop_stochastic_plan_batch as torch_plan_batch,
)
from rl_agents_torch.convert import from_numpy, graph_from_numpy, tree_to_numpy
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_torch.ops.kl_bound import kl_bound_torch
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS
from rl_agents_tpu.agents.tree_search import graph_based_stochastic as jgs
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing
from rl_agents_tpu.utils.math import kl_upper_bound as jax_kl_upper_bound

torch.set_num_threads(1)

ATOL = 1e-5
B = 8
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}
EXACT_FIELDS = ("visited", "n_count", "c_count", "sa_count", "sa_keys", "sa_child", "sa_n", "used")
BOUND_FIELDS = ("sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "value_lower", "value_upper")


def _garnet_case(width):
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=2)
    s = np.random.default_rng(0).integers(0, 16, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_mdp.FiniteMDPEnv(16, 4, mode="sparse")
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    plan = dict(num_actions=4, episodes=8, horizon=4, gamma=0.8, accuracy=1e-2,
                reward_threshold_coeff=1.0, transition_threshold_coeff=0.1, width=width)
    env_draw = lambda ks: jax.random.gumbel(ks, (2,), jnp.float32)
    return (env_j, params_j, states), (env_t, params_t, torch_mdp.MDPState), plan, env_draw


def _sailing_case(width):
    size = 5
    env_j = jax_sailing.SailingEnv(size=size, max_episode_steps=100)
    rng = np.random.default_rng(4)
    states = jax_sailing.SailingState(
        pos=rng.integers(0, size - 1, (B, 2)).astype(np.int32),
        wind=rng.integers(0, 8, B).astype(np.int32), t=np.zeros(B, np.int32))
    env_t = torch_sailing.SailingEnv(size=size, max_episode_steps=100)
    plan = dict(num_actions=8, episodes=6, horizon=5, gamma=0.9, accuracy=1e-2,
                reward_threshold_coeff=1.0, transition_threshold_coeff=0.1, width=width)
    env_draw = lambda ks: jax.random.uniform(jax.random.split(ks)[0])
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_sailing.SailingState), plan, env_draw


CASES = {"garnet_width2": lambda: _garnet_case(2), "sailing_width1": lambda: _sailing_case(1),
         "sailing_width3": lambda: _sailing_case(3)}


def _jax_draws(keys, episodes, horizon, num_actions, env_draw):
    """Each tree's draws (rl_agents_tpu/.../graph_based_stochastic.py:147,162,
    166,170,227): the action tie-breaks ``[E, H, B, A]``, the final tie-break
    ``[B, A]`` and the env's draws ``[E, H, B, ...]``."""
    def per_tree(key):
        ties, env = [], []
        for _ in range(episodes):
            key, k = jax.random.split(key)
            for _ in range(horizon):
                k, ka, ks = jax.random.split(k, 3)
                ties.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
                env.append(env_draw(ks))
        return jnp.stack(ties), jnp.stack(env), jax.random.gumbel(key, (num_actions,), jnp.float32)

    ties, env, final = (np.asarray(x) for x in jax.jit(jax.vmap(per_tree))(keys))
    ties = ties.reshape((len(keys), episodes, horizon, num_actions)).transpose(1, 2, 0, 3)
    env = np.moveaxis(env.reshape((len(keys), episodes, horizon) + env.shape[2:]), 0, 2)
    return (ties, final), env


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_match_with_jax_draws(name):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan, env_draw = CASES[name]()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_jnp)
    action_j, graph_j = jax.vmap(
        lambda s, o, k: jgs.gbop_stochastic_plan(env_j, params_j, s, o, k, **plan))(
        states_jnp, obs_j, keys)

    states_t = from_numpy(state_cls, states_j, device="cpu")
    noise, env_noise = _jax_draws(keys, plan["episodes"], plan["horizon"], plan["num_actions"],
                                  env_draw)
    tgs.gbop_stochastic_plan.vi_sweeps = tgs.gbop_stochastic_plan.vi_tree_sweeps = 0
    action_t, graph_t = torch_plan_batch(env_t, params_t, states_t,
                                         env_t.observe(params_t, states_t), noise=noise,
                                         env_noise=env_noise, device="cpu", **plan)
    np.testing.assert_array_equal(action_t.numpy(), np.asarray(action_j))
    got = tree_to_numpy(graph_t)
    for field in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(graph_j, field)),
                                      err_msg=field)
    for field in ("keys", "values", "count"):
        np.testing.assert_array_equal(getattr(got.table, field),
                                      np.asarray(getattr(graph_j.table, field)), err_msg=field)
    for field in BOUND_FIELDS:
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(graph_j, field)),
                                   atol=ATOL, err_msg=field)
    used = np.asarray(graph_j.used)
    assert used.max() <= graph_j.visited.shape[1]
    for arena_t, arena_j in zip(got.states, graph_j.states):
        for b in range(B):
            np.testing.assert_array_equal(arena_t[b, :used[b]], np.asarray(arena_j)[b, :used[b]])
    assert int(got.sa_n.max()) == min(plan["width"], 2)  # several next states were seen
    # the KL solve did real work, and the trees left the sweep loop at different trips
    assert np.ptp(got.sa_mu_ucb[got.sa_count > 0]) > 0.05
    stats = tgs.gbop_stochastic_plan
    assert stats.vi_tree_sweeps < stats.vi_sweeps * B
    if name.startswith("sailing"):
        assert got.sa_cum_reward.min() < -0.5  # negative sums went through the KL bound
    # a graph carried over from JAX converts to the port's arenas unchanged
    carried = graph_from_numpy(tgs.StochasticGraph, jax.tree.map(np.asarray, graph_j), state_cls,
                               device="cpu")
    for field in EXACT_FIELDS:
        assert torch.equal(getattr(carried, field), getattr(graph_t, field)), field
    assert torch.equal(carried.table.keys, graph_t.table.keys)


@pytest.mark.parametrize("lower", [False, True])
def test_kl_bound_torch_matches_jax_on_negative_sums(lower):
    """Sailing's rewards lie in [-1, 0) and +1 at the goal, so the reward sums
    are mostly negative: ``mu < 0``, an inverted interval for the lower bound.
    The plain version of the kernel follows JAX's ``kl_upper_bound`` there,
    ``jnp.clip`` order included (within 1e-5)."""
    rng = np.random.default_rng(3)
    count = rng.integers(0, 12, 4000).astype(np.float32)
    total = (rng.uniform(-1, 1, 4000) * count).astype(np.float32)
    total[:200] = -count[:200]       # mu == -1
    total[200:400] = count[200:400]  # mu == 1
    total[400:500] = 0.0
    threshold = (rng.choice([0.1, 1.0, 4.0], 4000) * np.log(rng.integers(1, 30, 4000))).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda s, n, t: jax_kl_upper_bound(s, n, t, lower=lower)))(
        total, count, threshold))
    got = kl_bound_torch(torch.tensor(total), torch.tensor(count), torch.tensor(threshold),
                         lower=lower, iters=NEWTON_MAX_ITERATIONS).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    negative = (total < 0) & (count > 0)
    assert negative.sum() > 1000
    if lower:  # the inverted interval [0, mu] clips to mu
        np.testing.assert_allclose(got[negative], (total / np.maximum(count, 1))[negative],
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["garnet_width2", "sailing_width1"])
def test_visited_bounds_equal_a_solve_of_their_final_statistics(name):
    """Each step solves both bounds of the entry it visits
    (``kl_bounds_pair_``): after a plan, every visited entry's ``sa_mu_ucb`` /
    ``sa_mu_lcb`` equal, bit for bit, a solve of its final sum and count at
    the reward threshold, and unvisited entries keep 1 / 0."""
    (_, _, states_j), (env_t, params_t, state_cls), plan, _ = CASES[name]()
    states_t = from_numpy(state_cls, states_j, device="cpu")
    _, graph = torch_plan_batch(env_t, params_t, states_t, env_t.observe(params_t, states_t),
                                torch.Generator().manual_seed(2), device="cpu", **plan)
    visited = graph.sa_count > 0
    threshold = torch.tensor(np.float32(plan["reward_threshold_coeff"])
                             * np.log(np.float32(plan["episodes"])))
    for field, lower in (("sa_mu_ucb", False), ("sa_mu_lcb", True)):
        want = kl_bound_torch(graph.sa_cum_reward[visited], graph.sa_count[visited].float(),
                              threshold, lower=lower, iters=NEWTON_MAX_ITERATIONS)
        assert torch.equal(getattr(graph, field)[visited], want), field
    assert (graph.sa_mu_ucb[~visited] == 1).all() and (graph.sa_mu_lcb[~visited] == 0).all()
    assert np.ptp(graph.sa_mu_ucb[visited].numpy()) > 0.05  # the solve did real work


def test_agent_prefers_the_rewarding_action():
    config = {"budget": 100, "gamma": 0.8, "max_next_states_count": 2}
    env = torch_mdp.make(dict(TWO_ARM), device="cpu")
    env.reset(seed=0)
    agent = tgs.StochasticGraphBasedPlannerAgent(env, dict(config), device="cpu")
    agent.seed(1)
    assert agent.act(0) == 1
    agent_j = jgs.StochasticGraphBasedPlannerAgent(jax_mdp.make(dict(TWO_ARM)), dict(config))
    for key in ("episodes", "horizon", "accuracy", "max_next_states_count"):
        assert agent.config[key] == agent_j.config[key], key
    graph = agent.last_plan_data
    E, H = agent.config["episodes"], agent.config["horizon"]
    assert graph.visited.shape == (1, 2 + E * H) and int(graph.used[0]) == 2
    assert int(graph.n_count[0].sum()) == E * H


def test_needs_a_generator_or_noise():
    (_, _, states_j), (env_t, params_t, state_cls), plan, _ = _garnet_case(2)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    with pytest.raises(ValueError, match="generator or noise"):
        tgs.gbop_stochastic_plan(env_t, params_t, states_t, states_t.s, None, device="cpu",
                                 **plan)
