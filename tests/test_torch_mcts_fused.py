"""The fused batched MCTS planner of the PyTorch port against
``rl_agents_tpu/agents/tree_search/mcts_fused.py``.

The port is fed the Gumbel draws JAX makes,
``gumbel(fold_in(fold_in(keys[0], episode), h), (2, A, B))``: actions, lengths
and the integer fields of the tree view must be equal, ``value`` within 1e-5.
The three properties of ``tests/agents/tree_search/test_mcts_fused.py`` are
carried over to the port drawing from its own generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search.batch import mcts_plan_batch as torch_mcts_batch
from rl_agents_torch.agents.tree_search.mcts import mcts_plan_batch_vmap as torch_mcts_vmap
from rl_agents_torch.agents.tree_search.mcts_fused import (
    mcts_plan_batch_fused as torch_mcts_fused,
)
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu.agents.tree_search.mcts_fused import mcts_plan_batch_fused as jax_mcts_fused
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

B = 64
ATOL = 1e-5
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0]}
PLAN = dict(num_actions=2, episodes=23, horizon=8)


def _two_arm_case(batch=B):
    env_j, params_j = jax_mdp.params_from_config(TWO_ARM)
    env_t, params_t = torch_mdp.params_from_config(TWO_ARM, device="cpu")
    states = jax_mdp.MDPState(s=np.zeros(batch, np.int32), t=np.zeros(batch, np.int32),
                              done=np.zeros(batch, bool))
    return (env_j, params_j, states), (env_t, params_t,
                                       from_numpy(torch_mdp.MDPState, states, device="cpu"))


def _cartpole_case(batch=B, lean=3.5):
    """Starts that lean far enough for some rollouts to end before the horizon."""
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, batch)).astype(np.float32)
    v[2] *= lean
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(batch, np.int32),
                                        done=np.zeros(batch, bool))
    return (env_j, params_j, states), (
        torch_cartpole.CartPoleEnv(max_episode_steps=200),
        from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        from_numpy(torch_cartpole.CartPoleState, states, device="cpu"))


def _jax_noise(keys, episodes, horizon, num_actions, batch):
    """rl_agents_tpu/agents/tree_search/mcts_fused.py:75,88,93,118, as
    ``[episodes, H, 2, A, B]``."""
    def draw(episode, h):
        key = jax.random.fold_in(jax.random.fold_in(keys[0], episode), h)
        return jax.random.gumbel(key, (2, num_actions, batch), jnp.float32)

    grid = jax.vmap(lambda e: jax.vmap(lambda h: draw(e, h))(jnp.arange(horizon)))
    return np.asarray(jax.jit(grid)(jnp.arange(episodes)))


@pytest.mark.parametrize("case,gamma,temperature", [
    (_cartpole_case, 0.95, 40.0), (_two_arm_case, 0.8, 5.0)])
def test_fused_plan_matches_with_jax_draws(case, gamma, temperature):
    (env_j, params_j, states_j), (env_t, params_t, states_t) = case()
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    probs = jnp.ones(2) / 2
    kw = dict(PLAN, gamma=gamma, temperature=temperature)
    actions_j, lengths_j, tree_j = jax_mcts_fused(
        env_j, params_j, jax.tree.map(jnp.asarray, states_j), keys, probs, probs, **kw)
    noise = _jax_noise(keys, PLAN["episodes"], PLAN["horizon"], 2, B)
    for planner in (torch_mcts_fused, torch_mcts_batch):
        actions_t, lengths_t, tree_t = planner(env_t, params_t, states_t, None, torch.ones(2) / 2,
                                               torch.ones(2) / 2, noise=noise, device="cpu", **kw)
        np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
        tree_np = tree_to_numpy(tree_t)
        for name in ("parent", "children", "count", "used"):
            np.testing.assert_array_equal(getattr(tree_np, name),
                                          np.asarray(getattr(tree_j, name)), err_msg=name)
        for name in ("value", "prior"):
            np.testing.assert_allclose(getattr(tree_np, name), np.asarray(getattr(tree_j, name)),
                                       atol=ATOL, err_msg=name)
    assert len(np.unique(np.asarray(actions_j)[:, 0])) > 1 or case is _two_arm_case


def _plan(planner, case, seed, **kw):
    env_t, params_t, states_t = case
    return planner(env_t, params_t, states_t, torch.Generator().manual_seed(seed),
                   torch.ones(2) / 2, torch.ones(2) / 2, device="cpu", **kw)


def test_fused_finds_rewarding_arm():
    actions, lengths, tree = _plan(torch_mcts_fused, _two_arm_case()[1], 3, **PLAN, gamma=0.8,
                                   temperature=5.0)
    assert actions.shape == (B, 8)
    assert (actions[:, 0] == 1).all()
    assert (tree.count[:, 0] == 23).all()  # root visited once per episode
    assert (lengths >= 1).all()


def test_fused_matches_vmap_statistically():
    """Fused and reference-structured planners agree on root statistics (same
    algorithm, different use of the random stream)."""
    batch = 48
    case = _cartpole_case(batch, lean=1.0)[1]
    kw = dict(num_actions=2, episodes=30, horizon=8, gamma=0.9, temperature=10.0)
    a1, _, t1 = _plan(torch_mcts_fused, case, 7, **kw)
    a2, _, t2 = _plan(torch_mcts_vmap, case, 7, **kw)
    v1, v2 = float(t1.value[:, 0].mean()), float(t2.value[:, 0].mean())
    assert abs(v1 - v2) / max(abs(v2), 1e-6) < 0.15
    p1 = np.bincount(a1[:, 0].numpy(), minlength=2) / batch
    p2 = np.bincount(a2[:, 0].numpy(), minlength=2) / batch
    assert np.abs(p1 - p2).max() < 0.35


def test_fused_tree_view_structure():
    batch = 8
    _, _, tree = _plan(torch_mcts_fused, _two_arm_case(batch)[1], 0, num_actions=2, episodes=10,
                       horizon=6, gamma=0.9, temperature=2.0)
    children, parent = tree.children.numpy(), tree.parent.numpy()
    assert (children[:, 0, 0] >= 0).all()
    for b in range(batch):
        for node in range(children.shape[1]):
            for child in children[b, node]:
                if child >= 0:
                    assert parent[b, child] == node
    assert (parent[:, 0] == -1).all()
    assert (tree.used >= 3).all()
    assert (tree.prior[:, 1:] == 0.5).all() and (tree.prior[:, 0] == 1).all()


def test_fused_plan_is_seeded_by_its_generator():
    case = _cartpole_case(8)[1]
    kw = dict(PLAN, gamma=0.95, temperature=40.0)
    first, again, other = (_plan(torch_mcts_fused, case, s, **kw) for s in (5, 5, 6))
    for a, b in zip(tree_to_numpy(first[2]), tree_to_numpy(again[2])):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(first[0], again[0])
    assert not torch.equal(first[2].count, other[2].count)
    with pytest.raises(ValueError, match="generator or noise"):
        torch_mcts_fused(*case, None, torch.ones(2) / 2, torch.ones(2) / 2, device="cpu", **kw)
