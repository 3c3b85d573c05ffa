"""Batch-first OPD and state-aware OPD of the PyTorch port against the JAX
package: ``jax.vmap(opd_plan)``, the fused ``opd_plan_batch``, the re-rooting
chain ``opd_step_subtree`` -> ``opd_grow_arena`` -> ``opd_plan_continue`` and
``jax.vmap(state_aware_plan)``.

The planners' only randomness is the Gumbel draw that breaks the ties of the
plan's greedy descent; the test rebuilds it from JAX's keys and injects it.
Then actions, lengths and every integer arena field are equal, and the bounds
agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import deterministic as td
from rl_agents_torch.agents.tree_search import state_aware as tsa
from rl_agents_torch.agents.tree_search.batch import opd_plan_batch as torch_opd_batch
from rl_agents_torch.agents.tree_search.batch import state_aware_plan_batch as torch_sa_batch
from rl_agents_torch.convert import from_numpy, opd_tree_from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_tpu.agents.tree_search import deterministic as jd
from rl_agents_tpu.agents.tree_search import state_aware as jsa
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing

torch.set_num_threads(1)

ATOL = 1e-5
B = 10
AGGREGATING = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 10000,
}
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}
# tests/test_torch_mdp_gape.py, with a terminal state: terminal_reward comes into play
TERMINAL = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 1, 2], [2, 2, 2]],
            "reward": [[0.0, 1.0, 0.6], [0.0, 1.0, 0.6], [0.0, 0.0, 0.0]],
            "terminal": [0, 0, 1], "max_episode_steps": 100}
OPD_EXACT = ("parent", "action", "depth", "children", "done", "leaf", "count", "used")
OPD_BOUNDS = ("reward", "value_lower", "value_upper")


def _mdp_case(config, plan):
    env_j, params_j = jax_mdp.params_from_config(config)
    S = env_j.num_states
    s = np.random.default_rng(0).integers(0, S - (config is TERMINAL), B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_mdp.FiniteMDPEnv(S, env_j.num_actions,
                                   max_episode_steps=config["max_episode_steps"])
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    return (env_j, params_j, states), (env_t, params_t, torch_mdp.MDPState), plan


def _cartpole_case():
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    start = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    start[2, : B // 2] += 0.15  # some poles close to falling: terminal children
    states = jax_cartpole.CartPoleState(*start, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=200)
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_cartpole.CartPoleState), \
        dict(num_actions=2, expansions=14, gamma=0.95, plan_capacity=14)


def _sailing_case():
    size = 5
    env_j = jax_sailing.SailingEnv(size=size, max_episode_steps=100)
    rng = np.random.default_rng(2)
    states = jax_sailing.SailingState(
        pos=rng.integers(0, size, (B, 2)).astype(np.int32),
        wind=rng.integers(0, 8, B).astype(np.int32), t=np.zeros(B, np.int32))
    env_t = torch_sailing.SailingEnv(size=size, max_episode_steps=100)
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_sailing.SailingState), \
        dict(num_actions=8, expansions=6, gamma=0.9, plan_capacity=6)


CASES = {
    "aggregating_mdp": lambda: _mdp_case(AGGREGATING, dict(num_actions=3, expansions=9, gamma=0.8,
                                                           plan_capacity=9)),
    "terminal_mdp": lambda: _mdp_case(TERMINAL, dict(num_actions=3, expansions=7, gamma=0.7,
                                                     terminal_reward=-1.0, plan_capacity=7)),
    "cartpole": _cartpole_case,
    "sailing": _sailing_case,
}


def _chain_noise(keys, plan_capacity, num_actions):
    """The tie-breaking draws of ``_greedy_plan`` (deterministic.py:130-131)
    and of state-aware OPD's plan (state_aware.py:182-183): one key split per
    plan step, ``[P, B, A]``."""
    def per_tree(key):
        out = []
        for _ in range(plan_capacity):
            key, sub = jax.random.split(key)
            out.append(jax.random.gumbel(sub, (num_actions,), jnp.float32))
        return jnp.stack(out)

    return np.transpose(np.asarray(jax.jit(jax.vmap(per_tree))(keys)), (1, 0, 2))


def _fused_noise(keys, plan_capacity, num_actions):
    """The draws of the fused batch planner (deterministic.py:514,527):
    ``fold_in(keys[0], h)``, shape ``(A, B)``; ``[P, A, B]``."""
    return np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(keys[0], h),
                                                  (num_actions, len(keys)), jnp.float32))
                     for h in range(plan_capacity)])


def _assert_opd_trees_match(tree_t, tree_j, state_atol=1e-6):
    got = tree_to_numpy(tree_t)
    for field in OPD_EXACT:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                      err_msg=field)
    for field in OPD_BOUNDS:
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                   atol=ATOL, err_msg=field)
    allocated = np.asarray(tree_j.parent) >= 0
    allocated[:, 0] = True
    for arena_t, arena_j in zip(got.states, tree_j.states):
        np.testing.assert_allclose(arena_t[allocated], np.asarray(arena_j)[allocated],
                                   atol=state_atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_opd_plan_and_batch_match_jax(name):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES[name]()
    A, P = plan["num_actions"], plan["plan_capacity"]
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    states_t = from_numpy(state_cls, states_j, device="cpu")

    actions_j, lengths_j, tree_j = jd.opd_plan_batch_vmap(env_j, params_j, states_jnp, keys,
                                                          **plan)
    actions_t, lengths_t, tree_t = td.opd_plan(env_t, params_t, states_t, None,
                                               noise=_chain_noise(keys, P, A), device="cpu",
                                               **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    _assert_opd_trees_match(tree_t, tree_j)
    assert (lengths_t >= 1).all() and int(tree_t.count[:, 0].min()) == 1 + plan["expansions"] * A
    again = td.opd_plan_batch_vmap(env_t, params_t, states_t, None,
                                   noise=_chain_noise(keys, P, A), device="cpu", **plan)
    assert torch.equal(again[0], actions_t)

    # the fused batch planner of the JAX package: the same trees, its own draws
    fused_j = jd.opd_plan_batch(env_j, params_j, states_jnp, keys, **plan)
    fused_t = torch_opd_batch(env_t, params_t, states_t, None, noise=_fused_noise(keys, P, A),
                              device="cpu", **plan)
    np.testing.assert_array_equal(fused_t[0].numpy(), np.asarray(fused_j[0]))
    np.testing.assert_array_equal(fused_t[1].numpy(), np.asarray(fused_j[1]))
    _assert_opd_trees_match(fused_t[2], fused_j[2])
    for field in OPD_EXACT + OPD_BOUNDS:
        assert torch.equal(getattr(fused_t[2], field), getattr(tree_t, field)), field
    if name == "terminal_mdp":
        assert bool(tree_t.done.any()) and float(tree_t.value_lower.min()) < 0
    if name == "cartpole":
        assert bool(tree_t.done.any())


@pytest.mark.parametrize("name", ["aggregating_mdp", "cartpole", "sailing"])
def test_continue_in_a_tree_carried_over_from_jax(name):
    """``opd_step_subtree`` -> ``opd_grow_arena`` -> ``opd_plan_continue`` on a
    tree that the JAX package grew, against the JAX package doing the same."""
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES[name]()
    A, P, R = plan["num_actions"], plan["plan_capacity"], plan["expansions"]
    gamma = plan["gamma"]
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    actions_j, _, tree_j = jd.opd_plan_batch_vmap(env_j, params_j, states_jnp, keys, **plan)
    first = jnp.maximum(actions_j[:, 0], 0)
    carry = R * A - A  # smaller than some subtrees: truncation re-leafs nodes
    stepped_j, valid_j = jax.vmap(
        lambda t, a: jd.opd_step_subtree(t, a, gamma, num_actions=A, out_capacity=carry))(
        tree_j, first)
    grown_j = jax.vmap(lambda t: jd.opd_grow_arena(t, R * A))(stepped_j)
    # the env moved on: the root state of the carried tree is refreshed
    moved_j = jax.vmap(env_j.step, in_axes=(None, 0, 0, None))(
        params_j, states_jnp, first, jnp.zeros((2,), jnp.uint32)).state
    keys2 = jax.random.split(jax.random.PRNGKey(13), B)
    cont_j = jax.vmap(lambda t, s, k: jd.opd_plan_continue(env_j, params_j, t, s, k, **plan))(
        grown_j, moved_j, keys2)

    carried = opd_tree_from_numpy(td.OPDTree, jax.tree.map(np.asarray, tree_j), state_cls,
                                  device="cpu")
    stepped_t, valid_t = td.opd_step_subtree(carried, torch.tensor(np.asarray(first)), gamma,
                                             num_actions=A, out_capacity=carry)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert bool(valid_t.all())
    _assert_opd_trees_match(stepped_t, stepped_j)
    assert int(stepped_t.used.max()) == carry + 1 - A or int(stepped_t.used.max()) <= carry
    grown_t = td.opd_grow_arena(stepped_t, R * A)
    _assert_opd_trees_match(grown_t, grown_j)
    moved_t = from_numpy(state_cls, jax.tree.map(np.asarray, moved_j), device="cpu")
    before = [t.clone() for t in grown_t[:-1]]
    cont_t = td.opd_plan_continue(env_t, params_t, grown_t, moved_t, None,
                                  noise=_chain_noise(keys2, P, A), device="cpu", **plan)
    np.testing.assert_array_equal(cont_t[0].numpy(), np.asarray(cont_j[0]))
    np.testing.assert_array_equal(cont_t[1].numpy(), np.asarray(cont_j[1]))
    _assert_opd_trees_match(cont_t[2], cont_j[2])
    assert all(torch.equal(a, b) for a, b in zip(before, grown_t[:-1]))  # the argument is kept


def test_never_explored_action_is_not_valid():
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES["aggregating_mdp"]()
    plan = dict(plan, expansions=1, plan_capacity=1)
    keys = jax.random.split(jax.random.PRNGKey(14), B)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    _, _, tree_t = td.opd_plan(env_t, params_t, states_t, None, noise=_chain_noise(keys, 1, 3),
                               device="cpu", **plan)
    _, _, tree_j = jd.opd_plan_batch_vmap(env_j, params_j, jax.tree.map(jnp.asarray, states_j),
                                          keys, **plan)
    step_j = lambda t, a: jax.vmap(lambda x: jd.opd_step_subtree(
        x, a, plan["gamma"], num_actions=3, out_capacity=3))(t)
    once_t, valid_t = td.opd_step_subtree(tree_t, 2, plan["gamma"], num_actions=3, out_capacity=3)
    once_j, valid_j = step_j(tree_j, 2)
    assert bool(valid_t.all()) and bool(np.asarray(valid_j).all())
    _assert_opd_trees_match(once_t, once_j)
    assert (once_t.used == 1).all() and bool(once_t.leaf[:, 0].all())
    # the new root is a leaf: none of its actions was explored
    _, valid_t = td.opd_step_subtree(once_t, 0, plan["gamma"], num_actions=3, out_capacity=3)
    _, valid_j = step_j(once_j, 0)
    assert not bool(valid_t.any()) and not bool(np.asarray(valid_j).any())


@pytest.mark.parametrize("name", ["aggregating_mdp", "terminal_mdp", "sailing"])
def test_state_aware_plan_matches_jax(name):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES[name]()
    A, P = plan["num_actions"], plan["plan_capacity"]
    keys = jax.random.split(jax.random.PRNGKey(15), B)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_jnp)
    actions_j, lengths_j, tree_j = jax.vmap(
        lambda s, o, k: jsa.state_aware_plan(env_j, params_j, s, o, k, **plan))(
        states_jnp, obs_j, keys)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    actions_t, lengths_t, tree_t = torch_sa_batch(
        env_t, params_t, states_t, env_t.observe(params_t, states_t), None,
        noise=_chain_noise(keys, P, A), device="cpu", **plan)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    got = tree_to_numpy(tree_t)
    for field in ("parent", "action", "depth", "children", "done", "leaf", "obs_id", "used"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                      err_msg=field)
    for field in ("keys", "values", "count"):
        np.testing.assert_array_equal(getattr(got.table, field),
                                      np.asarray(getattr(tree_j.table, field)), err_msg=field)
    for field in ("reward", "value_lower", "state_values"):
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                   atol=ATOL, err_msg=field)
    for arena_t, arena_j in zip(got.states, tree_j.states):
        np.testing.assert_array_equal(arena_t, np.asarray(arena_j))
    if name == "aggregating_mdp":  # only 4 distinct states despite many tree nodes
        assert int(got.table.count.max()) <= 4
        assert float(got.state_values[:, :4].min()) < 1 / (1 - plan["gamma"]) - 1e-3
    carried = opd_tree_from_numpy(tsa.StateAwareTree, jax.tree.map(np.asarray, tree_j), state_cls,
                                  device="cpu")
    assert torch.equal(carried.obs_id, tree_t.obs_id)
    assert torch.equal(carried.table.values, tree_t.table.values)


def test_bounds_equal_jax_bit_for_bit_only_with_the_fused_multiply_add(monkeypatch):
    """``value_lower + gamma ** (d - 1) * reward`` (deterministic.py:88,
    state_aware.py:94-95) and state-aware OPD's ``r + gamma * sv``
    (state_aware.py:151) are fused multiply-adds under XLA on the CPU: with
    ``utils/math.py::fma`` the port's bounds equal JAX's bit for bit on
    Sailing, whose rewards are not dyadic; with a multiply and an add some
    differ in the last place."""
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES["sailing"]()
    A, P = plan["num_actions"], plan["plan_capacity"]
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_jnp)
    tree_j = jd.opd_plan_batch_vmap(env_j, params_j, states_jnp, keys, **plan)[2]
    aware_j = jax.vmap(lambda s, o, k: jsa.state_aware_plan(env_j, params_j, s, o, k, **plan))(
        states_jnp, obs_j, keys)[2]

    def port_bounds():
        noise = _chain_noise(keys, P, A)
        tree = td.opd_plan(env_t, params_t, states_t, None, noise=noise, device="cpu", **plan)[2]
        aware = torch_sa_batch(env_t, params_t, states_t, env_t.observe(params_t, states_t), None,
                               noise=noise, device="cpu", **plan)[2]
        return {"opd lower": (tree.value_lower, tree_j.value_lower),
                "opd upper": (tree.value_upper, tree_j.value_upper),
                "state-aware lower": (aware.value_lower, aware_j.value_lower),
                "state values": (aware.state_values, aware_j.state_values)}

    for label, (got, want) in port_bounds().items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=label)
    plain = lambda a, b, c: a * b + c
    monkeypatch.setattr(td, "fma", plain)
    monkeypatch.setattr(tsa, "fma", plain)
    differing = {label: int((got.numpy() != np.asarray(want)).sum())
                 for label, (got, want) in port_bounds().items()}
    assert differing["opd lower"] > 0 and differing["state-aware lower"] > 0, differing


def test_opd_agent_carries_its_subtree():
    env = torch_cartpole.make({"max_episode_steps": 50}, device="cpu")
    obs, _ = env.reset(seed=0)
    agent = td.DeterministicPlannerAgent(
        env, {"budget": 24, "gamma": 0.95, "step_strategy": "subtree"}, device="cpu")
    agent.seed(0)
    sizes = []
    for _ in range(3):
        action = agent.act(obs)
        assert action in (0, 1)
        sizes.append((agent.carried_tree is not None, agent.last_plan_data.parent.shape[1]))
        obs, *_ = env.step(action)
    # the first plan starts fresh; later ones continue in the carried arena
    assert sizes == [(False, 25), (True, 48), (True, 48)]
    agent.reset()
    assert agent.carried_tree is None
    fresh = td.DeterministicPlannerAgent(env, {"budget": 24, "gamma": 0.95}, device="cpu")
    fresh.act(obs)
    fresh.act(obs)
    assert fresh.carried_tree is None


@pytest.mark.parametrize("agent_cls,module", [(td.DeterministicPlannerAgent, jd),
                                              (tsa.StateAwarePlannerAgent, jsa)])
def test_agents_prefer_the_rewarding_action(agent_cls, module):
    env = torch_mdp.make(dict(TWO_ARM), device="cpu")
    env.reset(seed=0)
    agent = agent_cls(env, {"budget": 60, "gamma": 0.8}, device="cpu")
    agent.seed(1)
    assert agent.act(0) == 1
    env_j = jax_mdp.make(dict(TWO_ARM))
    env_j.reset(seed=0)
    agent_j = getattr(module, agent_cls.__name__)(env_j, {"budget": 60, "gamma": 0.8})
    agent_j.seed(1)
    assert agent_j.act(0) == 1
    np.testing.assert_allclose(agent.last_plan_data.value_lower[0].numpy(),
                               np.asarray(agent_j.last_plan_data.value_lower), atol=ATOL)


def test_state_aware_agent_aggregates():
    env = torch_mdp.make(dict(AGGREGATING), device="cpu")
    env.reset(seed=0)
    agent = tsa.StateAwarePlannerAgent(env, {"budget": 60, "gamma": 0.8}, device="cpu")
    agent.seed(0)
    assert agent.act(0) == 1
    tree = agent.last_plan_data
    assert int(tree.table.count[0]) <= 4
    assert float(tree.state_values[0, :int(tree.table.count[0])].max()) <= 1 / (1 - 0.8) + 1e-5


def test_parity_planner_is_refused_by_name():
    """The parity planner (tests/test_torch_parity.py holds it
    against JAX), expands the tree that ``opd_plan`` expands; ``opd_plan``
    itself still refuses to plan without a generator or noise."""
    from rl_agents_torch.utils.pcg64 import pcg64_init

    (_, _, states_j), (env_t, params_t, state_cls), plan = CASES["aggregating_mdp"]()
    states_t = from_numpy(state_cls, states_j, device="cpu")
    stream, inc = pcg64_init(list(range(states_t[0].shape[0])), device="cpu")
    _, lengths, tree, _ = td.opd_plan_parity(env_t, params_t, states_t, stream, inc,
                                             device="cpu", **plan)
    _, _, want = td.opd_plan(env_t, params_t, states_t, torch.Generator().manual_seed(0),
                             device="cpu", **plan)
    assert torch.equal(tree.count, want.count) and torch.equal(tree.children, want.children)
    assert (lengths >= 1).all()
    with pytest.raises(ValueError, match="generator or noise"):
        (_, _, states_j), (env_t, params_t, state_cls), plan = CASES["aggregating_mdp"]()
        td.opd_plan(env_t, params_t, from_numpy(state_cls, states_j, device="cpu"), None,
                    device="cpu", **plan)
