"""Batch-first GBOP-D of the PyTorch port against ``jax.vmap(gbop_plan)`` of
the JAX package.

The planner's only randomness is the Gumbel draw that breaks the ties of each
node's optimistic action, one draw per round whose shape grows with the JAX
package's arena; the test rebuilds each round's draw from each tree's key at
that round's size and injects it. Then actions, lengths and every integer
arena field are equal, and the value bounds agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import graph_based as tgb
from rl_agents_torch.agents.tree_search.batch import gbop_plan_batch as torch_gbop_batch
from rl_agents_torch.convert import from_numpy, graph_from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_tpu.agents.tree_search import graph_based as jgb
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.envs import sailing as jax_sailing

torch.set_num_threads(1)

ATOL = 1e-5
# tests/agents/tree_search/test_remaining_planners.py: 4 states, many paths
AGGREGATING = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 10000,
}
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}


def _mdp_case(batch):
    env_j, params_j = jax_mdp.params_from_config(AGGREGATING)
    s = np.random.default_rng(0).integers(0, 4, batch).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(batch, np.int32), done=np.zeros(batch, bool))
    env_t = torch_mdp.FiniteMDPEnv(4, 3, max_episode_steps=10000)
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    return (env_j, params_j, states), (env_t, params_t, torch_mdp.MDPState), \
        dict(num_actions=3, expansions=7, gamma=0.8, accuracy=1e-2)


def _cartpole_case(batch):
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    start = np.random.default_rng(1).uniform(-0.05, 0.05, (4, batch)).astype(np.float32)
    states = jax_cartpole.CartPoleState(*start, t=np.zeros(batch, np.int32),
                                        done=np.zeros(batch, bool))
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=200)
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_cartpole.CartPoleState), \
        dict(num_actions=2, expansions=12, gamma=0.95, accuracy=1e-2)


def _sailing_case(batch):
    size = 5
    env_j = jax_sailing.SailingEnv(size=size, max_episode_steps=100)
    rng = np.random.default_rng(2)
    states = jax_sailing.SailingState(
        pos=rng.integers(0, size, (batch, 2)).astype(np.int32),
        wind=rng.integers(0, 8, batch).astype(np.int32), t=np.zeros(batch, np.int32))
    env_t = torch_sailing.SailingEnv(size=size, max_episode_steps=100)
    return (env_j, env_j.default_params(), states), \
        (env_t, env_t.default_params("cpu"), torch_sailing.SailingState), \
        dict(num_actions=8, expansions=6, gamma=0.9, accuracy=1e-2)


CASES = {"aggregating_mdp": _mdp_case, "cartpole": _cartpole_case, "sailing": _sailing_case}


def _jax_noise(keys, num_actions, expansions):
    """Each round's tie-breaking draw (rl_agents_tpu/.../graph_based.py:229,290),
    at that round's arena size: a list of ``[B, N_r, A]``."""
    A = num_actions
    N = -((1 + expansions * A) // -8) * 8
    sizes = [min(-((1 + (r + 1) * A) // -8) * 8, N) for r in range(expansions)]

    def per_tree(key):
        out = []
        for size in sizes:
            key, kd = jax.random.split(key)
            out.append(jax.random.gumbel(kd, (size, A)))
        return out

    return [np.asarray(g) for g in jax.jit(jax.vmap(per_tree))(keys)]


def _plan_both(name, batch):
    (env_j, params_j, states_j), (env_t, params_t, state_cls), plan = CASES[name](batch)
    keys = jax.random.split(jax.random.PRNGKey(3), batch)
    states_jnp = jax.tree.map(jnp.asarray, states_j)
    obs_j = jax.vmap(env_j.observe, in_axes=(None, 0))(params_j, states_jnp)
    actions_j, length_j, graph_j = jax.vmap(
        lambda s, o, k: jgb.gbop_plan(env_j, params_j, s, o, k, **plan))(states_jnp, obs_j, keys)

    states_t = from_numpy(state_cls, states_j, device="cpu")
    obs_t = env_t.observe(params_t, states_t)
    noise = _jax_noise(keys, plan["num_actions"], plan["expansions"])
    tgb._value_iteration_sweeps.sweeps = tgb._value_iteration_sweeps.tree_sweeps = 0
    actions_t, length_t, graph_t = torch_gbop_batch(env_t, params_t, states_t, obs_t,
                                                    noise=noise, device="cpu", **plan)
    return (actions_j, length_j, graph_j), (actions_t, length_t, graph_t), plan, state_cls


@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_match_with_jax_draws(name):
    batch = 12
    (actions_j, length_j, graph_j), (actions_t, length_t, graph_t), plan, state_cls = \
        _plan_both(name, batch)
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(length_t.numpy(), np.asarray(length_j))
    assert (length_t >= 1).all()
    got = tree_to_numpy(graph_t)
    for field in ("keys", "expanded", "children", "used"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(graph_j, field)),
                                      err_msg=field)
    for field in ("rewards", "value_lower", "value_upper"):
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(graph_j, field)),
                                   atol=ATOL, err_msg=field)
    used = np.asarray(graph_j.used)
    for arena_t, arena_j in zip(graph_t.states, graph_j.states):
        arena_t, arena_j = arena_t.numpy(), np.asarray(arena_j)
        for b in range(batch):  # rows beyond `used` were never written by either
            np.testing.assert_allclose(arena_t[b, :used[b]], arena_j[b, :used[b]], atol=1e-6)
    # the bounds did tighten, and the trees left the sweep loop at different trips
    assert float(graph_t.value_lower[:, 0].min()) > 0 or name == "sailing"
    stats = tgb._value_iteration_sweeps
    if name != "cartpole":  # CartPole pays 1 a step, so its upper bounds stay at 1 / (1 - gamma)
        assert float(graph_t.value_upper[:, 0].median()) < 1 / (1 - plan["gamma"]) - 1e-3
        assert stats.tree_sweeps < stats.sweeps * batch
    # a graph carried over from JAX converts to the port's arenas unchanged
    carried = graph_from_numpy(tgb.Graph, jax.tree.map(np.asarray, graph_j), state_cls,
                               device="cpu")
    assert torch.equal(carried.children, graph_t.children)
    assert torch.equal(carried.keys, graph_t.keys)
    swept = tgb._value_iteration_sweeps(carried, torch.tensor(np.float32(plan["gamma"])),
                                        plan["accuracy"])
    np.testing.assert_allclose(swept.value_upper.numpy(), np.asarray(graph_j.value_upper),
                               atol=plan["accuracy"])
    assert (swept.value_upper <= carried.value_upper + ATOL).all()


def test_bounds_equal_jax_bit_for_bit_only_with_the_fused_multiply_add(monkeypatch):
    """``rewards + gamma * child value`` (graph_based.py:75,97) is one fused
    multiply-add under XLA on the CPU: with ``utils/math.py::fma`` every bound
    of the port equals JAX's bit for bit, with a multiply and an add some
    differ in the last place (and a descent compares such values for ties)."""
    (_, _, graph_j), (_, _, graph_t), _, _ = _plan_both("aggregating_mdp", 12)
    for field in ("value_lower", "value_upper"):
        np.testing.assert_array_equal(getattr(graph_t, field).numpy(),
                                      np.asarray(getattr(graph_j, field)), err_msg=field)
    monkeypatch.setattr(tgb, "fma", lambda a, b, c: a * b + c)
    (_, _, graph_j), (_, _, graph_t), _, _ = _plan_both("aggregating_mdp", 12)
    differing = (graph_t.value_upper.numpy() != np.asarray(graph_j.value_upper)).sum()
    assert 0 < differing
    np.testing.assert_allclose(graph_t.value_upper.numpy(), np.asarray(graph_j.value_upper),
                               atol=ATOL)


def _jax_get_or_insert(keys, used, okeys):
    fn = jax.vmap(jgb._get_or_insert)
    return [np.asarray(x) for x in fn(jnp.asarray(keys, jnp.uint32), jnp.asarray(used, jnp.int32),
                                      jnp.asarray(okeys, jnp.uint32))]


@pytest.mark.parametrize("case,okeys", [
    ("all_existing", [11, 13, 11, 12]),
    ("all_fresh", [21, 22, 23, 24]),
    ("duplicate_fresh", [21, 21, 22, 21]),
    ("mixed", [21, 12, 21, 22]),
    ("duplicate_existing", [13, 13, 30, 13]),
])
def test_get_or_insert_matches_jax(case, okeys):
    keys = np.zeros((3, 12), np.int64)
    keys[:, :3] = [11, 12, 13]
    keys[1, 3:5] = [21, 99]  # a tree that already holds one of the keys
    keys[2, 3] = 21          # a stale key beyond `used` must not match
    used = np.array([3, 5, 3])
    okeys = np.tile(np.asarray(okeys, np.int64), (3, 1))
    want = _jax_get_or_insert(keys, used, okeys)
    got = tgb._get_or_insert(torch.tensor(keys), torch.tensor(used), torch.tensor(okeys))
    for g, w, field in zip(got, want, ("keys", "used", "node_ids", "fresh", "slots")):
        g = g.numpy()
        if field == "slots":  # a slot is read only where its action is fresh
            fresh = got[3].numpy()
            g, w = g[fresh], w[fresh]
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"{case}: {field}")


def test_undersized_capacity_is_refused():
    (_, _, states_j), (env_t, params_t, state_cls), plan = _mdp_case(2)
    states_t = from_numpy(state_cls, states_j, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tgb.gbop_plan(env_t, params_t, states_t, states_t.s, torch.Generator().manual_seed(0),
                      capacity=8, device="cpu", **plan)
    with pytest.raises(ValueError, match="generator or noise"):
        tgb.gbop_plan(env_t, params_t, states_t, states_t.s, None, device="cpu", **plan)


def test_agent_prefers_the_rewarding_action():
    env = torch_mdp.make(dict(TWO_ARM), device="cpu")
    env.reset(seed=0)
    agent = tgb.GraphBasedPlannerAgent(env, {"budget": 40, "gamma": 0.8}, device="cpu")
    agent.seed(1)
    assert agent.act(0) == 1
    graph = agent.last_plan_data
    assert int(graph.used[0]) == 2  # two states, however many expansions
    env_j = jax_mdp.make(dict(TWO_ARM))
    env_j.reset(seed=0)
    agent_j = jgb.GraphBasedPlannerAgent(env_j, {"budget": 40, "gamma": 0.8})
    agent_j.seed(1)
    assert agent_j.act(0) == 1
    np.testing.assert_allclose(graph.value_lower[0].numpy(),
                               np.asarray(agent_j.last_plan_data.value_lower), atol=ATOL)
