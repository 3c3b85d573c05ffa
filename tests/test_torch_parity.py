"""The parity planners of the PyTorch port against the JAX package's, in
float64 (``jax.experimental.enable_x64``).

Each JAX planner plans one tree per seed; the port plans all seeds at once,
one PCG64 stream per tree. The plans, the integer arena fields (counts,
children) and the final stream digits are equal; the float64 fields agree
within 1e-12, the tolerance of the JAX parity tests for float64 ``log``
ulps (the OLOP bound). The MDPs are the JAX parity tests': the loop MDP for
MCTS and OLOP, the tie-rich MDP for OPD."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from rl_agents_torch.agents.tree_search.deterministic import opd_plan_parity as t_opd
from rl_agents_torch.agents.tree_search.mcts_parity import mcts_plan_parity as t_mcts
from rl_agents_torch.agents.tree_search.olop_parity import olop_plan_parity as t_olop
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.utils.pcg64 import pcg64_init as t_init
from rl_agents_tpu.agents.tree_search.deterministic import opd_plan_parity as j_opd
from rl_agents_tpu.agents.tree_search.mcts_parity import mcts_plan_parity as j_mcts
from rl_agents_tpu.agents.tree_search.olop_parity import olop_plan_parity as j_olop
from rl_agents_tpu.envs import finite_mdp as jax_mdp
from rl_agents_tpu.utils.pcg64 import pcg64_init as j_init

torch.set_num_threads(1)

LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]], "terminal": [0, 0, 0, 0],
        "max_episode_steps": 1000}
TIES = {"mode": "deterministic", "transition": [[1, 2, 0], [1, 3, 3], [2, 3, 3], [3, 3, 3]],
        "reward": [[0.5, 0.5, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0, 0, 0]],
        "terminal": [0, 0, 0, 0], "max_episode_steps": 100}
SEEDS = [0, 3, 7]
FTOL = 1e-12


def _envs(config, dtype=torch.float32):
    env_j, params_j = jax_mdp.params_from_config(config)
    env_t, params_t = torch_mdp.params_from_config(config, device="cpu", dtype=dtype)
    state_j = jax_mdp.MDPState(s=jnp.int32(0), t=jnp.int32(0), done=jnp.asarray(False))
    n = len(SEEDS)
    state_t = torch_mdp.MDPState(s=torch.zeros(n, dtype=torch.int64),
                                 t=torch.zeros(n, dtype=torch.int64),
                                 done=torch.zeros(n, dtype=torch.bool))
    return (env_j, params_j, state_j), (env_t, params_t, state_t)


def _check_stream(stream_t, b, stream_j):
    np.testing.assert_array_equal(stream_t.digits[b].numpy(), np.asarray(stream_j.digits))
    assert bool(stream_t.has_buf[b]) == bool(stream_j.has_buf)
    assert int(stream_t.buf[b]) == int(stream_j.buf)


def _check_arena(arena_t, b, arena_j, int_fields, float_fields):
    for name in int_fields:
        np.testing.assert_array_equal(getattr(arena_t, name)[b].numpy(),
                                      np.asarray(getattr(arena_j, name)), err_msg=name)
    for name in float_fields:
        np.testing.assert_allclose(getattr(arena_t, name)[b].numpy(),
                                   np.asarray(getattr(arena_j, name)), atol=FTOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("float64_rewards", [False, True])
def test_mcts_parity_matches_jax(float64_rewards):
    """With the JAX package's float32 rewards, and with float64 rewards (the
    port's ``dtype`` option; the JAX side gets float64 tables by hand)."""
    plan = dict(num_actions=3, episodes=25, horizon=6, gamma=0.8, temperature=10.0)
    dtype = torch.float64 if float64_rewards else torch.float32
    (env_j, params_j, state_j), (env_t, params_t, state_t) = _envs(LOOP, dtype)
    stream_t, inc_t = t_init(SEEDS, device="cpu")
    actions_t, lengths_t, arena_t, stream_t, totals_t = t_mcts(
        env_t, params_t, state_t, stream_t, inc_t, device="cpu", **plan)
    with enable_x64():
        if float64_rewards:
            params_j = params_j._replace(reward=jnp.asarray(np.asarray(LOOP["reward"],
                                                                       np.float64)))
        for b, seed in enumerate(SEEDS):
            stream_j, inc_j = j_init(seed)
            actions_j, length_j, arena_j, stream_j, totals_j = j_mcts(
                env_j, params_j, state_j, stream_j, inc_j, **plan)
            assert int(lengths_t[b]) == int(length_j)
            np.testing.assert_array_equal(actions_t[b].numpy(), np.asarray(actions_j))
            _check_arena(arena_t, b, arena_j, ("children", "parent", "count", "used"),
                         ("prior", "value"))
            np.testing.assert_allclose(totals_t[b].numpy(), np.asarray(totals_j), atol=FTOL,
                                       rtol=0)
            _check_stream(stream_t, b, stream_j)
    assert params_t.reward.dtype == dtype
    assert int(arena_t.count[0, 0]) == plan["episodes"]


@pytest.mark.parametrize("continuation", ["zeros", "uniform"])
def test_olop_parity_matches_jax(continuation):
    plan = dict(num_actions=3, episodes=12, horizon=4, gamma=0.8,
                continuation_uniform=continuation == "uniform")
    (env_j, params_j, state_j), (env_t, params_t, state_t) = _envs(LOOP)
    stream_t, inc_t = t_init(SEEDS, device="cpu")
    actions_t, lengths_t, arena_t, stream_t = t_olop(env_t, params_t, state_t, stream_t, inc_t,
                                                     device="cpu", **plan)
    with enable_x64():
        for b, seed in enumerate(SEEDS):
            stream_j, inc_j = j_init(seed)
            actions_j, length_j, arena_j, stream_j = j_olop(env_j, params_j, state_j, stream_j,
                                                            inc_j, **plan)
            assert int(lengths_t[b]) == int(length_j)
            np.testing.assert_array_equal(actions_t[b].numpy(), np.asarray(actions_j))
            _check_arena(arena_t, b, arena_j,
                         ("children", "parent", "depth", "count", "done", "used"),
                         ("cum", "mu", "vu"))
            _check_stream(stream_t, b, stream_j)


@pytest.mark.parametrize("expansions", [3, 20])
def test_opd_parity_matches_jax(expansions):
    """The tie-rich MDP: the plan's ties are broken on each seed's stream
    (after 3 expansions the root's two best actions tie)."""
    plan = dict(num_actions=3, expansions=expansions, gamma=0.5, plan_capacity=32)
    (env_j, params_j, state_j), (env_t, params_t, state_t) = _envs(TIES)
    seeds = [0, 1, 7, 42]
    state_t = torch_mdp.MDPState(*(x[:1].expand(len(seeds)).clone() for x in state_t))
    stream_t, inc_t = t_init(seeds, device="cpu")
    actions_t, lengths_t, tree_t, stream_t = t_opd(env_t, params_t, state_t, stream_t, inc_t,
                                                   device="cpu", **plan)
    start, _ = t_init(seeds, device="cpu")
    for b, seed in enumerate(seeds):
        stream_j, inc_j = j_init(seed)
        actions_j, length_j, tree_j, stream_j = j_opd(env_j, params_j, state_j, stream_j, inc_j,
                                                      **plan)
        assert int(lengths_t[b]) == int(length_j)
        np.testing.assert_array_equal(actions_t[b].numpy(), np.asarray(actions_j))
        np.testing.assert_array_equal(tree_t.count[b].numpy(), np.asarray(tree_j.count))
        _check_stream(stream_t, b, stream_j)
    if expansions == 3:  # ties were broken: every stream drew, and not alike
        assert (stream_t.digits != start.digits).any(dim=1).all()
        assert len({tuple(a) for a in actions_t.tolist()}) > 1
