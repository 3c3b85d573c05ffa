"""Batch-first MCTS of the PyTorch port against the JAX package.

``mcts_plan`` is fed the Gumbel draws that ``jax.vmap(mcts_plan)`` makes from
each tree's key, rebuilt here by replaying the key chain. Integer arena
fields, actions and lengths must be equal; ``value`` and ``prior`` agree
within 1e-5 (they have been equal so far: the port tabulates the discounts as
XLA rounds them and emulates its fused multiply-add in the return)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.agents.tree_search import mcts as tm
from rl_agents_torch.agents.tree_search.common import arena_subtree_gather as torch_gather
from rl_agents_torch.convert import from_numpy, tree_from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu import factory as jax_factory
from rl_agents_tpu.agents.tree_search import mcts as jm
from rl_agents_tpu.agents.tree_search.common import arena_subtree_gather as jax_gather
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
B = 4
ATOL = 1e-5
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}
INT_FIELDS = ("parent", "children", "count", "used")
FLOAT_FIELDS = ("value", "prior")


def _two_arm_case():
    env_j, params_j = jax_mdp.params_from_config(TWO_ARM)
    env_t, params_t = torch_mdp.params_from_config(TWO_ARM, device="cpu")
    s = np.array([0, 1, 0, 1], np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    plan = dict(num_actions=2, episodes=10, horizon=4, gamma=0.8, temperature=5.0)
    return (env_j, params_j, states), (env_t, params_t,
                                       from_numpy(torch_mdp.MDPState, states, device="cpu")), plan


def _cartpole_case():
    """Starts leaning far enough that some rollouts end before the horizon."""
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    v[2] *= 3.5
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    plan = dict(num_actions=2, episodes=12, horizon=10, gamma=0.95, temperature=40.0)
    return (env_j, params_j, states), (
        torch_cartpole.CartPoleEnv(max_episode_steps=200),
        from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        from_numpy(torch_cartpole.CartPoleState, states, device="cpu")), plan


CASES = {"two_arm": _two_arm_case, "cartpole": _cartpole_case}


def _tree_draws(key, episodes, horizon, num_actions):
    """The Gumbel draws of one tree's ``mcts_plan`` (rl_agents_tpu/.../mcts.py:84,
    99-100, 129-130): per episode the key splits four ways, and every descent
    step and every rollout scan iteration splits its chain three ways and
    draws ``categorical(ka, logits)`` = ``argmax(logits + gumbel(ka))``.
    Returns ``(descend, rollout)``, each ``[episodes, horizon, A]``, and the
    rollout keys."""
    descend, rollout, keys = [], [], []
    for _ in range(episodes):
        key, kdesc, kroll, _ = jax.random.split(key, 4)
        for chain, out in ((kdesc, descend), (kroll, rollout)):
            row = []
            for _ in range(horizon):
                chain, ka, _ = jax.random.split(chain, 3)
                row.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
                if out is rollout:
                    keys.append(ka)
            out.append(jnp.stack(row))
    return jnp.stack(descend), jnp.stack(rollout), jnp.stack(keys)


def _draws(keys, plan):
    """``(descend, rollout)`` as the port takes them, ``[episodes, H, B, A]``."""
    fn = jax.jit(jax.vmap(lambda k: _tree_draws(k, plan["episodes"], plan["horizon"],
                                                plan["num_actions"])))
    descend, rollout, rollout_keys = fn(keys)
    return (np.transpose(np.asarray(descend), (1, 2, 0, 3)),
            np.transpose(np.asarray(rollout), (1, 2, 0, 3)), rollout_keys)


def _assert_trees_match(tree_t, tree_j):
    tree_t = tree_to_numpy(tree_t)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tree_t, name), np.asarray(getattr(tree_j, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tree_t, name), np.asarray(getattr(tree_j, name)),
                                   atol=ATOL, err_msg=name)


def _uniform(num_actions):
    return jnp.ones(num_actions) / num_actions, torch.ones(num_actions) / num_actions


def _jax_plan(case, keys):
    (env_j, params_j, states_j), _, plan = case
    probs_j, _ = _uniform(plan["num_actions"])
    return jm.mcts_plan_batch_vmap(env_j, params_j, jax.tree.map(jnp.asarray, states_j), keys,
                                   probs_j, probs_j, **plan)


def test_rebuilt_draws_reproduce_jax_actions():
    """``argmax(logits + rebuilt gumbel)`` is the action ``jax.random.categorical``
    draws from the same key, here for the rollout policy."""
    plan = dict(num_actions=3, episodes=3, horizon=4)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    _, rollout, rollout_keys = _draws(keys, plan)
    logits = jnp.log(jnp.asarray([0.2, 0.5, 0.3]))
    want = jax.vmap(jax.vmap(lambda k: jax.random.categorical(k, logits)))(rollout_keys)
    got = np.argmax(np.asarray(logits) + rollout, axis=-1)           # [E, H, B]
    np.testing.assert_array_equal(np.transpose(got, (2, 0, 1)).reshape(B, -1), np.asarray(want))
    assert len(np.unique(got)) == 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_mcts_plan_matches_with_jax_draws(name):
    case = CASES[name]()
    _, (env_t, params_t, states_t), plan = case
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    actions_j, lengths_j, tree_j = _jax_plan(case, keys)
    descend, rollout, _ = _draws(keys, plan)
    _, probs_t = _uniform(plan["num_actions"])
    for planner in (tm.mcts_plan, tm.mcts_plan_batch_vmap):
        actions_t, lengths_t, tree_t = planner(env_t, params_t, states_t, None, probs_t, probs_t,
                                               noise=(descend, rollout), device="cpu", **plan)
        np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
        _assert_trees_match(tree_t, tree_j)
    assert (tree_t.count[:, 0] == plan["episodes"]).all()


def test_mcts_plan_with_a_preference_prior_matches():
    case = _two_arm_case()
    (env_j, params_j, states_j), (env_t, params_t, states_t), plan = case
    policy = {"type": "preference", "action": 1, "ratio": 3}
    prior_j, prior_t = jm.make_prior_fn(policy, 2), tm.make_prior_fn(policy, 2)
    np.testing.assert_allclose(prior_t.numpy(), np.asarray(prior_j), atol=1e-7)
    with pytest.raises(ValueError, match="Unknown policy type"):
        tm.make_prior_fn({"type": "nope"}, 2)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    out_j = jax.vmap(lambda s, k: jm.mcts_plan(env_j, params_j, s, k, prior_j, prior_j, **plan))(
        jax.tree.map(jnp.asarray, states_j), keys)
    descend, rollout, _ = _draws(keys, plan)
    out_t = tm.mcts_plan(env_t, params_t, states_t, None, prior_t, prior_t,
                         noise=(descend, rollout), device="cpu", **plan)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    _assert_trees_match(out_t[2], out_j[2])


def test_mcts_plan_draws_from_the_generator():
    _, (env_t, params_t, states_t), plan = _cartpole_case()
    _, probs_t = _uniform(2)
    run = lambda seed: tm.mcts_plan(env_t, params_t, states_t, torch.Generator().manual_seed(seed),
                                    probs_t, probs_t, device="cpu", **plan)
    first, again, other = run(3), run(3), run(4)
    for a, b in zip(tree_to_numpy(first[2]), tree_to_numpy(again[2])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[2].value.numpy(), other[2].value.numpy())
    with pytest.raises(ValueError, match="generator or noise"):
        tm.mcts_plan(env_t, params_t, states_t, None, probs_t, probs_t, device="cpu", **plan)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("out_capacity", [20, 7])
def test_subtree_gather_and_step_by_prior_match_on_jax_arenas(name, out_capacity):
    """Arenas planned by JAX go through both packages' re-rooting; capacity 7
    truncates the carried subtree at a sibling-block boundary."""
    case = CASES[name]()
    plan = case[2]
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    _, _, tree_j = _jax_plan(case, keys)
    tree_t = tree_from_numpy(tm.MCTSTree, jax.tree.map(np.asarray, tree_j), device="cpu")
    for action in range(plan["num_actions"]):
        want = jax.vmap(lambda p, c, u: jax_gather(p, c, u, action, out_capacity))(
            tree_j.parent, tree_j.children, tree_j.used)
        got = torch_gather(tree_t.parent, tree_t.children, tree_t.used, action, out_capacity)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        new_j, valid_j = jax.vmap(lambda t: jm.mcts_step_by_prior(
            t, action, num_actions=plan["num_actions"], out_capacity=out_capacity))(tree_j)
        new_t, valid_t = tm.mcts_step_by_prior(tree_t, action, num_actions=plan["num_actions"],
                                               out_capacity=out_capacity)
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
        assert valid_t.all()
        new_t = tree_to_numpy(new_t)
        for field in INT_FIELDS:
            np.testing.assert_array_equal(getattr(new_t, field), np.asarray(getattr(new_j, field)),
                                          err_msg=field)
        for field in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(new_t, field), np.asarray(getattr(new_j, field)),
                                       atol=1e-6, err_msg=field)


def test_step_by_prior_golden_and_unexplored_action():
    """tests/agents/tree_search/test_mcts.py::test_mcts_step_by_prior_conversion,
    with a second tree whose action was never explored."""
    parent = [[-1, 0, 0, 1, 1, -1, -1, -1], [-1] * 8]
    children = [[[1, 2], [3, 4]] + [[-1, -1]] * 6, [[-1, -1]] * 8]
    tree = tm.MCTSTree(
        parent=torch.tensor(parent), children=torch.tensor(children),
        count=torch.tensor([[10, 6, 3, 2, 1, 0, 0, 0], [0] * 8]),
        value=torch.tensor([[0.5, 0.6, 0.4, 0.7, 0.2, 0, 0, 0], [0.0] * 8]),
        prior=torch.full((2, 8), 0.125), used=torch.tensor([5, 1]))
    new_tree, valid = tm.mcts_step_by_prior(tree, 0, num_actions=2, out_capacity=6)
    assert valid.tolist() == [True, False]
    assert new_tree.used.tolist() == [3, 0]
    assert new_tree.parent[0, :3].tolist() == [-1, 0, 0]
    assert new_tree.children[0, 0].tolist() == [1, 2]
    assert (new_tree.count == 0).all()
    np.testing.assert_allclose(new_tree.value[0, :3].numpy(), [0.6, 0.7, 0.2])
    np.testing.assert_allclose(new_tree.prior[0, :3].numpy(),
                               [0.125, 0.5 * 3 / 5 + 0.25, 0.5 * 2 / 5 + 0.25], rtol=1e-6)
    grown = tm.mcts_grow_arena(new_tree, 4)
    assert grown.parent.shape == (2, 10) and grown.children.shape == (2, 10, 2)
    assert (grown.parent[:, 6:] == -1).all() and (grown.prior[:, 6:] == 1).all()
    assert torch.equal(grown.used, new_tree.used)


def test_mcts_plan_continue_matches_after_a_re_root():
    case = _cartpole_case()
    (env_j, params_j, states_j), (env_t, params_t, states_t), plan = case
    A, E = plan["num_actions"], plan["episodes"]
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    _, _, tree_j = _jax_plan(case, keys)
    carried_j, valid = jax.vmap(lambda t: jm.mcts_step_by_prior(
        t, 1, num_actions=A, out_capacity=E * A))(tree_j)
    assert bool(valid.all())
    carried_j = jax.vmap(lambda t: jm.mcts_grow_arena(t, E * A))(carried_j)
    carried_t = tree_from_numpy(tm.MCTSTree, jax.tree.map(np.asarray, carried_j), device="cpu")
    before = [t.clone() for t in carried_t]
    # the env moves on by the chosen action in both packages
    next_j = jax.vmap(lambda s, k: env_j.step(params_j, s, 1, k).state)(
        jax.tree.map(jnp.asarray, states_j), keys)
    next_t = from_numpy(torch_cartpole.CartPoleState, jax.tree.map(np.asarray, next_j),
                        device="cpu")
    keys2 = jax.random.split(jax.random.PRNGKey(7), B)
    probs_j, probs_t = _uniform(A)
    actions_j, lengths_j, out_j = jax.vmap(lambda t, s, k: jm.mcts_plan_continue(
        env_j, params_j, t, s, k, probs_j, probs_j, **plan))(carried_j, next_j, keys2)
    descend, rollout, _ = _draws(keys2, plan)
    actions_t, lengths_t, out_t = tm.mcts_plan_continue(
        env_t, params_t, carried_t, next_t, None, probs_t, probs_t, noise=(descend, rollout),
        device="cpu", **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    _assert_trees_match(out_t, out_j)
    assert (out_t.used > carried_t.used).all()
    for old, kept in zip(before, carried_t):  # the carried arenas are not written
        assert torch.equal(old, kept)


def _agent_draws(agent_j, plans):
    """The draws of the JAX agent's next ``plans`` plans: ``next_key`` splits
    the agent's key once per plan (rl_agents_tpu/.../common.py:176-178)."""
    key, out = agent_j.key, []
    shape = dict(episodes=agent_j.config["episodes"], horizon=agent_j.config["horizon"],
                 num_actions=2)
    for _ in range(plans):
        key, sub = jax.random.split(key)
        descend, rollout, _ = _draws(sub[None], shape)
        out.append(torch.tensor(np.stack([descend, rollout])))
    return out


@pytest.mark.parametrize("step_strategy", ["reset", "prior"])
def test_agent_acts_like_the_jax_agent_given_the_same_draws(step_strategy, monkeypatch):
    config = json.loads((CONFIGS / "CartPoleEnv" / "MCTSAgent.json").read_text())
    config.update(budget=60, step_strategy=step_strategy)
    env_j = jax_factory.load_environment(CONFIGS / "CartPoleEnv" / "env.json")
    env_t = torch_factory.load_environment(CONFIGS / "CartPoleEnv" / "env.json", device="cpu")
    obs_j, _ = env_j.reset(seed=3)
    env_t.state = from_numpy(torch_cartpole.CartPoleState,
                             {k: np.asarray(v)[None] for k, v in env_j.state._asdict().items()},
                             device="cpu")
    obs_t = env_t.functional.observe(env_t.params, env_t.state)[0].numpy()
    agent_j = jax_factory.load_agent(dict(config), env_j)
    agent_t = torch_factory.load_agent(dict(config), env_t, device="cpu")
    assert isinstance(agent_t, tm.MCTSAgent)
    assert agent_t.config["temperature"] == 200
    assert (agent_t.config["episodes"], agent_t.config["horizon"]) == \
        (agent_j.config["episodes"], agent_j.config["horizon"])
    agent_j.seed(4)
    steps = 6
    # the port's planner asks for one episode's noise at a time
    draws = iter(np.concatenate([d.numpy().transpose(1, 0, 2, 3, 4) for d in
                                 _agent_draws(agent_j, steps)]))
    monkeypatch.setattr(tm, "gumbel", lambda shape, generator, device: torch.tensor(next(draws)))
    for _ in range(steps):
        action_j, action_t = agent_j.act(obs_j), agent_t.act(obs_t)
        assert action_t == action_j
        np.testing.assert_allclose(agent_t.last_plan_data.value[0].numpy(),
                                   np.asarray(agent_j.last_plan_data.value), atol=ATOL)
        obs_j, *_ = env_j.step(action_j)
        obs_t, *_ = env_t.step(action_t)
        np.testing.assert_allclose(obs_t, np.asarray(obs_j), atol=ATOL)
    assert (agent_t.carried_tree is not None) == (step_strategy == "prior")
    agent_t.reset()
    assert agent_t.carried_tree is None


def test_agent_defaults_and_closed_loop_message():
    env_t = torch_cartpole.make({"max_episode_steps": 20}, device="cpu")
    agent = tm.MCTSAgent(env_t, {"budget": 40, "gamma": 0.9, "horizon": 5}, device="cpu")
    assert (agent.config["episodes"], agent.config["horizon"]) == (8, 5)
    assert agent.config["temperature"] == pytest.approx(2 / (1 - 0.9))
    agent.seed(0)
    assert agent.act(None) in (0, 1)
    # closed loop (tests/test_torch_mcts_dpw.py holds it against JAX)
    agent = torch_factory.load_agent({"__class__": "MCTSAgent", "closed_loop": True,
                                      "budget": 20}, env_t, device="cpu")
    assert agent.act(None) in (0, 1)
    assert int(agent.last_plan_data.d_count[0, 0]) == agent.config["episodes"]


# ---- a stochastic env: the env's own draws replayed from JAX's env keys ----

GRID_STOCH = CONFIGS / "DummyEnv" / "gridenv_stoch.json"


def _garnet_stochastic_case(batch=B):
    """JAX's garnet of branching 2, carried across (the port's own garnet
    draws another MDP); its step draws ``gumbel(ks, (2,))``."""
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=2)
    env_t = torch_mdp.FiniteMDPEnv(env_j.num_states, env_j.num_actions, mode=env_j.mode,
                                   max_episode_steps=env_j.max_episode_steps)
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    s = np.random.default_rng(3).integers(0, 16, batch).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(batch, np.int32), done=np.zeros(batch, bool))
    plan = dict(num_actions=4, episodes=12, horizon=4, gamma=0.8, temperature=5.0)
    draw = lambda k: jax.random.gumbel(k, (2,), jnp.float32)
    return (env_j, params_j, states), (env_t, params_t,
                                       from_numpy(torch_mdp.MDPState, states, device="cpu")), \
        plan, draw


def _grid_stochastic_case(batch=B):
    """``DummyEnv/gridenv_stoch.json``: an action is dropped when
    ``uniform(ks)`` falls below 0.3. Starts near the reward's centre, so that
    the returns depend on the drops."""
    from rl_agents_torch.envs import gridenv as torch_grid
    from rl_agents_tpu.envs import gridenv as jax_grid

    config = json.loads(GRID_STOCH.read_text())
    env_j, env_t = jax_grid.make_grid(config), torch_grid.make_grid(config, device="cpu")
    start = np.random.default_rng(0).integers(7, 13, (batch, 2)).astype(np.float32)
    states_j = jax_grid.GridState(start, np.zeros(batch, np.int32))
    states_t = torch_grid.GridState(torch.tensor(start), torch.zeros(batch, dtype=torch.int64))
    plan = dict(num_actions=4, episodes=12, horizon=4, gamma=0.7, temperature=5.0)
    draw = lambda k: jax.random.uniform(k)
    return (env_j.functional, env_j.params, states_j), \
        (env_t.functional, env_t.params, states_t), plan, draw


STOCHASTIC_CASES = {"garnet": _garnet_stochastic_case, "gridenv_stoch": _grid_stochastic_case}


def _tree_draws_with_env(key, episodes, horizon, num_actions, draw):
    """``_tree_draws`` with the env's draw of every step: each descent and
    rollout step of ``mcts_plan`` splits its chain into ``(chain, ka, ks)``
    and steps the env with ``ks`` (rl_agents_tpu/.../mcts.py:99-101,129-131).
    ``(descend, rollout, env_descend, env_rollout)``, each
    ``[episodes, horizon, ...]``."""
    out = ([], [], [], [])
    for _ in range(episodes):
        key, kdesc, kroll, _ = jax.random.split(key, 4)
        for chain, g_out, env_out in ((kdesc, out[0], out[2]), (kroll, out[1], out[3])):
            g_row, env_row = [], []
            for _ in range(horizon):
                chain, ka, ks = jax.random.split(chain, 3)
                g_row.append(jax.random.gumbel(ka, (num_actions,), jnp.float32))
                env_row.append(draw(ks))
            g_out.append(jnp.stack(g_row))
            env_out.append(jnp.stack(env_row))
    return tuple(jnp.stack(x) for x in out)


def _tree_first(x):
    """``[B, episodes, H, ...]`` -> ``[episodes, H, B, ...]``."""
    return np.moveaxis(np.asarray(x), 0, 2)


@pytest.mark.parametrize("name", sorted(STOCHASTIC_CASES))
def test_mcts_plan_on_a_stochastic_env_matches_with_jax_env_keys(name):
    """``mcts_plan`` given the tie-breaking, rollout and env draws of
    ``jax.vmap(mcts_plan)``'s keys builds JAX's trees; other env draws build
    other trees, so the env's draws are the injected ones."""
    (env_j, params_j, states_j), (env_t, params_t, states_t), plan, draw = \
        STOCHASTIC_CASES[name]()
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    probs_j, probs_t = _uniform(plan["num_actions"])
    actions_j, lengths_j, tree_j = jax.vmap(lambda s, k: jm.mcts_plan(
        env_j, params_j, s, k, probs_j, probs_j, **plan))(jax.tree.map(jnp.asarray, states_j),
                                                           keys)
    fn = jax.jit(jax.vmap(lambda k: _tree_draws_with_env(
        k, plan["episodes"], plan["horizon"], plan["num_actions"], draw)))
    descend, rollout, env_descend, env_rollout = (_tree_first(x) for x in fn(keys))
    for planner in (tm.mcts_plan, tm.mcts_plan_batch_vmap):
        actions_t, lengths_t, tree_t = planner(
            env_t, params_t, states_t, None, probs_t, probs_t, noise=(descend, rollout),
            env_noise=(env_descend, env_rollout), device="cpu", **plan)
        np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
        _assert_trees_match(tree_t, tree_j)
    other = tm.mcts_plan(env_t, params_t, states_t, None, probs_t, probs_t,
                         noise=(descend, rollout), device="cpu", **plan,
                         env_noise=(env_descend[::-1].copy(), env_rollout[::-1].copy()))
    assert not np.array_equal(other[2].value.numpy(), tree_t.value.numpy())


def _fused_draws_with_env(keys, episodes, horizon, num_actions, batch, draw):
    """The fused planner's draws (rl_agents_tpu/.../mcts_fused.py:75,88,93,
    118-120): ``ka = fold_in(fold_in(keys[0], episode), h)`` gives the
    ``[2, A, B]`` Gumbel draws, and ``split(fold_in(ka, 1), B)`` one env key a
    tree. ``([episodes, H, 2, A, B], [episodes, H, B, ...])``."""
    def step(episode, h):
        ka = jax.random.fold_in(jax.random.fold_in(keys[0], episode), h)
        env_keys = jax.random.split(jax.random.fold_in(ka, 1), batch)
        return (jax.random.gumbel(ka, (2, num_actions, batch), jnp.float32),
                jax.vmap(draw)(env_keys))

    grid = jax.vmap(lambda e: jax.vmap(lambda h: step(e, h))(jnp.arange(horizon)))
    return tuple(np.asarray(x) for x in jax.jit(grid)(jnp.arange(episodes)))


@pytest.mark.parametrize("name", sorted(STOCHASTIC_CASES))
def test_fused_plan_on_a_stochastic_env_matches_with_jax_env_keys(name):
    """``mcts_plan_batch_fused`` (and ``mcts_plan_batch``, which routes to
    it) given the draws of JAX's fused planner, env keys included, builds
    its tree view."""
    from rl_agents_torch.agents.tree_search.mcts_fused import mcts_plan_batch_fused
    from rl_agents_tpu.agents.tree_search.mcts_fused import (
        mcts_plan_batch_fused as jax_fused,
    )

    batch = 16
    (env_j, params_j, states_j), (env_t, params_t, states_t), plan, draw = \
        STOCHASTIC_CASES[name](batch)
    keys = jax.random.split(jax.random.PRNGKey(9), batch)
    probs_j, probs_t = _uniform(plan["num_actions"])
    actions_j, lengths_j, tree_j = jax_fused(env_j, params_j, jax.tree.map(jnp.asarray, states_j),
                                             keys, probs_j, probs_j, **plan)
    noise, env_noise = _fused_draws_with_env(keys, plan["episodes"], plan["horizon"],
                                             plan["num_actions"], batch, draw)
    for planner in (mcts_plan_batch_fused, tm.mcts_plan_batch):
        actions_t, lengths_t, tree_t = planner(env_t, params_t, states_t, None, probs_t, probs_t,
                                               noise=noise, env_noise=env_noise, device="cpu",
                                               **plan)
        np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
        _assert_trees_match(tree_t, tree_j)
