"""Batch-first MDP-GapE of the PyTorch port against
``jax.vmap(mdp_gape_plan)`` of the JAX package.

On deterministic MDPs the env ignores its key, so with the tie-breaking Gumbel
draws rebuilt from each tree's key the two plans must agree: chosen action,
``episodes_used`` and every integer arena field equal, ``d_cum_reward``
equal, the confidence and value bounds within 1e-5 (the KL and Newton solves'
``log`` differs by ulps between XLA and torch). The port sizes its decision
arena for the ``episodes + 1`` episodes the loop runs, the JAX package for
fewer: the comparison takes the JAX arena's length of the port's. On a
stochastic MDP the env's Gumbel draws are rebuilt from the keys too and
injected (``env_noise``), and the plans agree in the same way; with the port's
own generator the root action is compared in distribution."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import mdp_gape as tg
from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch as torch_gape_batch
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.ops.kl_bound import kl_bound_torch
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS
from rl_agents_tpu.agents.tree_search.mdp_gape import MDPGapEAgent as JaxMDPGapEAgent
from rl_agents_tpu.agents.tree_search.mdp_gape import mdp_gape_plan as jax_gape_plan
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
B = 8
ATOL = 1e-5
# tests/test_torch_olop.py
LOOP_CONFIG = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 1000,
}
# tests/agents/tree_search/test_olop.py, with a terminal state added
TWO_ARM_CONFIG = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 1, 2], [2, 2, 2]],
    "reward": [[0.0, 1.0, 0.6], [0.0, 1.0, 0.6], [0.0, 0.0, 0.0]],
    "terminal": [0, 0, 1],
    "max_episode_steps": 100,
}
EXACT_FIELDS = ("d_parent", "d_depth", "d_count", "d_cum_reward", "d_children", "d_done",
                "c_parent", "c_depth", "c_count", "c_child_keys", "c_children", "c_n_children",
                "d_used", "c_used")
BOUND_FIELDS = ("d_mu_ucb", "d_mu_lcb", "d_value_upper", "d_value_lower", "c_value_upper",
                "c_value_lower")


def _torch_side(env_j, params_j, states):
    env_t = torch_mdp.FiniteMDPEnv(env_j.num_states, env_j.num_actions, mode=env_j.mode,
                                   max_episode_steps=env_j.max_episode_steps)
    return (env_t, from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu"),
            from_numpy(torch_mdp.MDPState, states, device="cpu"))


def _states(num_states, batch=B, seed=0, fixed=None):
    s = np.random.default_rng(seed).integers(0, num_states, batch).astype(np.int32)
    if fixed is not None:
        s[:] = fixed
    return jax_mdp.MDPState(s=s, t=np.zeros(batch, np.int32), done=np.zeros(batch, bool))


def _config_case(config, plan):
    env_j, params_j = jax_mdp.params_from_config(config)
    states = _states(env_j.num_states)
    if config is TWO_ARM_CONFIG:
        states = states._replace(s=np.minimum(states.s, 1))
    return (env_j, params_j, states), _torch_side(env_j, params_j, states), plan


def _garnet_case(branching, plan, batch=B, fixed=None):
    """JAX's garnet, carried across: the port's own garnet draws another MDP."""
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=branching)
    states = _states(16, batch, fixed=fixed)
    return (env_j, params_j, states), _torch_side(env_j, params_j, states), plan


GARNET_PLAN = dict(num_actions=4, episodes=20, horizon=5, gamma=0.7, accuracy=0.0,
                   confidence=0.9, transition_threshold_coeff=0.1, width=2)
CASES = {
    "loop": lambda: _config_case(LOOP_CONFIG, dict(
        num_actions=3, episodes=10, horizon=3, gamma=0.8, accuracy=0.5, confidence=0.9,
        transition_threshold_coeff=0.1, width=2)),
    "loop_width1_stops_early": lambda: _config_case(LOOP_CONFIG, dict(
        num_actions=3, episodes=12, horizon=3, gamma=0.8, accuracy=2.2, confidence=0.5,
        transition_threshold_coeff=0.1, width=1)),
    "two_arm_terminal": lambda: _config_case(TWO_ARM_CONFIG, dict(
        num_actions=3, episodes=10, horizon=3, gamma=0.8, accuracy=0.3, confidence=0.9,
        transition_threshold_coeff=0.5, width=2)),
    "garnet_deterministic": lambda: _garnet_case(1, GARNET_PLAN),
    "garnet_deterministic_confidence1": lambda: _garnet_case(1, dict(GARNET_PLAN, confidence=1.0)),
}


def _jax_noise(keys, episodes, horizon, num_actions):
    """The Gumbel draws of each tree's optimistic tie-break
    (rl_agents_tpu/.../mdp_gape.py:201,207,219), ``[episodes + 1, H, B, A]``:
    the loop runs while ``episode <= episodes``."""
    def per_tree(key):
        out = []
        for _ in range(episodes + 1):
            key, chain = jax.random.split(key)
            row = []
            for _ in range(horizon):
                chain, ka, _ = jax.random.split(chain, 3)
                row.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
            out.append(jnp.stack(row))
        return jnp.stack(out)

    return np.transpose(np.asarray(jax.jit(jax.vmap(per_tree))(keys)), (1, 2, 0, 3))


def _jax_env_noise(keys, episodes, horizon, outcomes):
    """The Gumbel draws of each tree's next state
    (rl_agents_tpu/envs/finite_mdp.py:87 with the step key ``ks`` of
    mdp_gape.py:207,223), ``[episodes + 1, H, B, K]``."""
    def per_tree(key):
        out = []
        for _ in range(episodes + 1):
            key, chain = jax.random.split(key)
            row = []
            for _ in range(horizon):
                chain, _, ks = jax.random.split(chain, 3)
                row.append(jax.random.gumbel(ks, (outcomes,), jnp.float32))
            out.append(jnp.stack(row))
        return jnp.stack(out)

    return np.transpose(np.asarray(jax.jit(jax.vmap(per_tree))(keys)), (1, 2, 0, 3))


def _jax_plan(case, keys):
    (env_j, params_j, states_j), _, plan = case
    return jax.vmap(lambda s, k: jax_gape_plan(env_j, params_j, s, k, **plan))(
        jax.tree.map(jnp.asarray, states_j), keys)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_match_with_jax_draws(name):
    case = CASES[name]()
    _, (env_t, params_t, states_t), plan = case
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    best_j, used_j, tree_j = _jax_plan(case, keys)
    noise = _jax_noise(keys, plan["episodes"], plan["horizon"], plan["num_actions"])
    best_t, used_t, tree_t = torch_gape_batch(env_t, params_t, states_t, noise=noise,
                                              device="cpu", **plan)
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(used_t.numpy(), np.asarray(used_j))
    if "stops_early" in name:
        assert used_t.min() < plan["episodes"] + 1 and len(np.unique(used_t.numpy())) > 1
    else:
        assert (used_t == plan["episodes"] + 1).all()
    # the JAX arena holds 2 + E*H decision nodes: no tree may have needed more
    assert int(np.asarray(tree_j.d_used).max()) <= tree_j.d_parent.shape[1]
    tree_np = tree_to_numpy(tree_t)
    sizes = {"d": tree_j.d_parent.shape[1], "c": tree_j.c_parent.shape[1]}
    for field in EXACT_FIELDS + BOUND_FIELDS:
        got, want = getattr(tree_np, field), np.asarray(getattr(tree_j, field))
        if got.ndim >= 2:
            rest = got[:, sizes[field[0]]:]
            assert (rest == rest[:, :1]).all(), f"{field}: the spare slots were written"
            got = got[:, :sizes[field[0]]]
        if field in EXACT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=field)
    assert np.ptp(np.asarray(tree_j.d_mu_ucb)) > 0.05  # the KL solve did real work


def _assert_trees_match(tree_t, tree_j):
    tree_np = tree_to_numpy(tree_t)
    sizes = {"d": tree_j.d_parent.shape[1], "c": tree_j.c_parent.shape[1]}
    for field in EXACT_FIELDS + BOUND_FIELDS:
        got, want = getattr(tree_np, field), np.asarray(getattr(tree_j, field))
        if got.ndim >= 2:
            got = got[:, :sizes[field[0]]]
        if field in EXACT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=field)


def test_stochastic_garnet_plans_match_with_jax_draws():
    """Branching 2: with the tie-breaking and the next-state Gumbel draws both
    rebuilt from each tree's key, the chosen action, ``episodes_used`` and
    every integer arena field equal the JAX package's, ``d_cum_reward`` too,
    and the bounds agree within 1e-5."""
    case = _garnet_case(2, GARNET_PLAN)
    _, (env_t, params_t, states_t), plan = case
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    best_j, used_j, tree_j = _jax_plan(case, keys)
    assert int(np.asarray(tree_j.d_used).max()) <= tree_j.d_parent.shape[1]
    noise = _jax_noise(keys, plan["episodes"], plan["horizon"], plan["num_actions"])
    env_noise = _jax_env_noise(keys, plan["episodes"], plan["horizon"], 2)
    best_t, used_t, tree_t = torch_gape_batch(env_t, params_t, states_t, noise=noise,
                                              env_noise=env_noise, device="cpu", **plan)
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(used_t.numpy(), np.asarray(used_j))
    _assert_trees_match(tree_t, tree_j)
    assert (np.asarray(tree_j.c_n_children).max(axis=1) == 2).all()  # both next states were seen


def test_visited_bounds_equal_a_solve_of_their_final_statistics():
    """The bounds of a node are solved once per episode, after the descent
    (``kl_bounds_pair_`` over the path): after a plan, every visited node's
    ``d_mu_ucb`` / ``d_mu_lcb`` equal, bit for bit, a solve of its final
    ``d_cum_reward`` / ``d_count`` at ``reward_threshold`` of that count, and
    unvisited nodes keep 1 / 0. That holds only while the deferral is exact."""
    case = _garnet_case(2, dict(GARNET_PLAN, confidence=0.5))
    _, (env_t, params_t, states_t), plan = case
    _, used, tree = torch_gape_batch(env_t, params_t, states_t, torch.Generator().manual_seed(3),
                                     device="cpu", **plan)
    assert (used == plan["episodes"] + 1).all()
    visited = tree.d_count > 0
    visited[:, 0] = False  # the root holds no reward statistics
    count = tree.d_count[visited]
    threshold = tg.reward_threshold(count, plan["horizon"], plan["num_actions"],
                                    plan["confidence"])
    for field, lower in (("d_mu_ucb", False), ("d_mu_lcb", True)):
        want = kl_bound_torch(tree.d_cum_reward[visited], count.float(), threshold, lower=lower,
                              iters=NEWTON_MAX_ITERATIONS)
        assert torch.equal(getattr(tree, field)[visited], want), field
    assert (tree.d_mu_ucb[~visited] == 1).all() and (tree.d_mu_lcb[~visited] == 0).all()
    assert int(count.max()) > 1 and np.ptp(tree.d_mu_ucb[visited].numpy()) > 0.05


def test_stochastic_garnet_root_action_distribution():
    """Branching 2: next states are drawn from a ``torch.Generator`` here and
    from ``jax.random`` keys there, so 64 trees from one state are compared
    by the share of each chosen action (tolerance 0.25 on shares whose
    standard error is about 0.06)."""
    batch = 64
    case = _garnet_case(2, GARNET_PLAN, batch=batch, fixed=0)
    _, (env_t, params_t, states_t), plan = case
    best_j, used_j, _ = _jax_plan(case, jax.random.split(jax.random.PRNGKey(1), batch))
    best_t, used_t, tree_t = torch_gape_batch(env_t, params_t, states_t,
                                              torch.Generator().manual_seed(1), device="cpu",
                                              **plan)
    share_j = np.bincount(np.asarray(best_j), minlength=4) / batch
    share_t = np.bincount(best_t.numpy(), minlength=4) / batch
    assert np.abs(share_t - share_j).max() < 0.25, (share_t, share_j)
    assert int(np.argmax(share_t)) == int(np.argmax(share_j))
    assert (used_t == plan["episodes"] + 1).all()
    assert (tree_t.c_n_children.max(dim=1).values == 2).all()  # both next states were seen
    again = torch_gape_batch(env_t, params_t, states_t, torch.Generator().manual_seed(1),
                             device="cpu", **plan)
    assert torch.equal(again[0], best_t)
    with pytest.raises(ValueError, match="generator or noise"):
        torch_gape_batch(env_t, params_t, states_t, device="cpu", **plan)


def test_agent_from_the_corpus_config_constructs_and_acts(monkeypatch):
    """``mdp-gape.json`` on the port's garnet, through ``load_agent``; on the
    CPU the planner must not reach the CUDA build."""
    from rl_agents_torch.ops import kl_bound as kl_module

    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(kl_module, "build", forbidden)
    monkeypatch.setattr(kl_module, "_load", forbidden)
    launches = kl_module.kl_bound.launches
    env = torch_factory.load_environment(CONFIGS / "FiniteMDPEnv" / "env_garnet.json",
                                         device="cpu")
    assert env.functional.mode == "sparse" and env.mdp.transition.shape == (16, 4, 2)
    agent = torch_factory.load_agent(CONFIGS / "FiniteMDPEnv" / "agents" / "mdp-gape.json", env,
                                     device="cpu")
    assert isinstance(agent, tg.MDPGapEAgent)
    config = json.loads((CONFIGS / "FiniteMDPEnv" / "agents" / "mdp-gape.json").read_text())
    agent_j = JaxMDPGapEAgent(jax_mdp.make({"id": "finite-mdp", "generator": "garnet"}),
                              dict(config, __class__="MDPGapEAgent"))
    for key in ("episodes", "horizon", "accuracy", "confidence", "max_next_states_count"):
        assert agent.config[key] == agent_j.config[key], key
    assert (agent.config["episodes"], agent.config["horizon"]) == (20, 5)
    obs, _ = env.reset(seed=0)
    agent.seed(0)
    action = agent.act(obs)
    assert action in range(4)
    assert agent.budget_used == 21 * 5
    tree = agent.last_plan_data
    assert tree.d_parent.shape == (1, 1 + 21 * 5) and int(tree.c_count[0].sum()) == 21 * 5
    assert torch.isfinite(tree.c_value_upper).all()
    assert kl_module.kl_bound.launches == launches


def test_horizon_from_accuracy():
    env = torch_mdp.make(dict(LOOP_CONFIG), device="cpu")
    config = {"budget": 60, "gamma": 0.8, "accuracy": 1.0, "horizon_from_accuracy": True}
    agent = tg.MDPGapEAgent(env, dict(config), device="cpu")
    agent_j = JaxMDPGapEAgent(jax_mdp.make(dict(LOOP_CONFIG)), dict(config))
    assert (agent.config["episodes"], agent.config["horizon"]) == \
        (agent_j.config["episodes"], agent_j.config["horizon"])
    with pytest.raises(ValueError, match="budget too small"):
        tg.MDPGapEAgent(env, dict(config, budget=11), device="cpu")
