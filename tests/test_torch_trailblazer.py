"""TrailBlazer of the PyTorch port against the JAX package, on the loop MDP
of bench.py:646-649 (gamma 0.5, delta 0.1, epsilon 4, oracle budget 500) and
on the two-arm MDP. The MDPs are deterministic, so the recursion is the same
whoever runs the oracle: the values agree within 1e-6 and the oracle calls
and dispatch counts are equal, for one instance and for a lockstep batch."""
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import trailblazer as tt
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu.agents.tree_search import trailblazer as jt
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]], "terminal": [0, 0, 0, 0],
        "max_episode_steps": 10_000}
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 10_000}
BENCH = dict(gamma=0.5, delta=0.1, epsilon=4.0, max_oracle_calls=500)


@pytest.mark.parametrize("config,kw", [(LOOP, BENCH),
                                       (TWO_ARM, dict(gamma=0.5, delta=0.1, epsilon=1.0,
                                                      max_oracle_calls=300))])
def test_single_instance_matches_jax(config, kw):
    env_j, env_t = jax_mdp.make(config), torch_mdp.make(config, device="cpu")
    env_j.reset(seed=0)
    env_t.reset(seed=0)
    tb_j, tb_t = jt.TrailBlazer(env_j, **kw), tt.TrailBlazer(env_t, **kw)
    value_j, value_t = tb_j.run(), tb_t.run()
    np.testing.assert_allclose(value_t, value_j, atol=1e-6)
    assert tb_t.oracle_calls == tb_j.oracle_calls
    assert tb_t.dispatches == tb_j.dispatches
    assert 0 < tb_t.dispatches < tb_t.oracle_calls


def test_batched_instances_match_jax():
    """Eight lockstep instances from different states of the loop MDP."""
    env_j, env_t = jax_mdp.make(LOOP), torch_mdp.make(LOOP, device="cpu")
    states_j, states_t = [], []
    for s in [0, 1, 2, 3, 0, 1, 2, 3]:
        env_j.state = env_j.state._replace(s=np.int32(s))
        states_j.append(env_j.state)
        states_t.append(env_t.state._replace(s=torch.tensor([s])))
    batched_j = jt.BatchedTrailBlazer(env_j, states_j, **BENCH)
    batched_t = tt.BatchedTrailBlazer(env_t, states_t, **BENCH)
    values_j, values_t = batched_j.run(), batched_t.run()
    np.testing.assert_allclose(values_t, values_j, atol=1e-6)
    assert batched_t.dispatches == batched_j.dispatches
    single = tt.TrailBlazer(env_t, **BENCH)
    single.run()
    assert batched_t.dispatches < 8 * single.dispatches  # rounds are shared
