"""The MiniGrid surrogates of the PyTorch port against the JAX package: the
item layouts of every corpus id, 40-step rollouts (bit-equal; the stochastic
variant under JAX's replayed drop draws), and KL-OLOP planning on
``MiniGrid-Empty-16x16-v0`` at ``GridWorld/agents/kl-olop.json``'s sizes, the
indexed KL form's path on this env (its plain version on the CPU)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search.batch import olop_plan_batch as torch_olop_batch
from rl_agents_torch.agents.tree_search.common import allocation
from rl_agents_torch.envs import minigrid as torch_minigrid
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.ops import kl_bound as kl_module
from rl_agents_torch.utils.noise import threefry_randint, threefry_split, threefry_uniform
from rl_agents_tpu.agents.tree_search.batch import olop_plan_batch as jax_olop_batch
from rl_agents_tpu.envs import minigrid as jax_minigrid
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment
from test_torch_olop import _assert_plans_match
from test_torch_small_envs import discrete_actions, raw, rollout, uniform_draws

torch.set_num_threads(1)

GRIDWORLD = Path(__file__).resolve().parent.parent / "scripts" / "configs" / "GridWorld"
IDS = ("MiniGrid-Empty-16x16-v0", "MiniGrid-Collect-9x9-v0", "MiniGrid-Collect-Stochastic-9x9-v0")
TREES = 8


def olop_draws(keys, episodes, horizon, num_actions):
    """The uniform continuation actions and the env's drop draws that
    ``olop_plan`` takes from each tree's key
    (rl_agents_tpu/agents/tree_search/olop.py:94,118-121: one chain an
    episode, ``ka`` and ``ks`` a step), replayed on the host, each
    ``[episodes, horizon, B]``."""
    actions, drops = [], []
    for key in keys:
        key, a_rows, d_rows = raw(key), [], []
        for _ in range(episodes):
            key, k = threefry_split(key, 2)
            a_row, d_row = [], []
            for _ in range(horizon):
                k, ka, ks = threefry_split(k, 3)
                a_row.append(threefry_randint(ka, num_actions))
                d_row.append(threefry_uniform(ks, (), 0.0, 1.0))
            a_rows.append(a_row)
            d_rows.append(d_row)
        actions.append(a_rows)
        drops.append(d_rows)
    return (np.transpose(np.array(actions), (1, 2, 0)),
            np.transpose(np.array(drops, np.float32), (1, 2, 0)))


@pytest.mark.parametrize("env_file", ["empty.json", "collect.json", "collect_stochastic.json"])
def test_corpus_layouts_equal_jax(env_file):
    config = json.loads((GRIDWORLD / env_file).read_text())
    env_j, env_t = jax_load_environment(config), load_environment(config, device="cpu")
    f_j, f_t = env_j.functional, env_t.functional
    assert (f_t.size, f_t.task, f_t.items, f_t.stochasticity, f_t.max_episode_steps) == \
        (f_j.size, f_j.task, f_j.items, f_j.stochasticity, f_j.max_episode_steps)
    assert f_t.item_cells == f_j._item_cells
    np.testing.assert_array_equal(env_t.params.items.numpy(), np.asarray(env_j.params["items"]))
    np.testing.assert_array_equal(env_t.reset(seed=0)[0], np.asarray(env_j.reset(seed=0)[0]))


@pytest.mark.parametrize("env_id", IDS)
def test_rollouts_are_bit_equal_under_jax_draws(env_id):
    env_j = jax_minigrid.make({"id": env_id})
    env_t = torch_minigrid.make({"id": env_id}, device="cpu")
    # mostly forward, so that the walk reaches items and walls
    actions = np.minimum(discrete_actions(4, seed=5), 2)
    state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, actions,
                    step_noise=uniform_draws)
    assert (state.pos != 1).any()


def test_reaching_the_goal_rewards_as_jax():
    """The Empty reward ``1 - 0.9 t / max_steps`` at several step limits:
    XLA folds 0.9 / max_steps into one factor."""
    for limit in (30, 37, 1024):
        env_j = jax_minigrid.make({"id": IDS[0], "max_episode_steps": limit})
        env_t = torch_minigrid.make({"id": IDS[0], "max_episode_steps": limit}, device="cpu")
        path = [2] * 14 + [1] + [2] * 14 + [0] * 11
        actions = np.array([path] * 4).T
        state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, actions,
                        step_noise=uniform_draws)
        assert (state.pos == 14).all()


def test_kl_olop_plans_on_the_empty_grid_match_jax():
    """``olop_plan_batch`` at ``kl-olop.json``'s sizes: budget 500 at gamma
    0.8 is 55 episodes x horizon 9 (``max_depth: 4`` is read by neither
    package), uniform continuation from JAX's replayed draws."""
    episodes, horizon = allocation(500, 0.8)
    assert (episodes, horizon) == (55, 9)
    env_j = jax_minigrid.make({"id": IDS[0]})
    env_t = torch_minigrid.make({"id": IDS[0]}, device="cpu")
    rng = np.random.default_rng(3)
    pos = rng.integers(8, 14, (TREES, 2)).astype(np.int32)
    dirs = rng.integers(0, 4, TREES).astype(np.int32)
    states_j = jax_minigrid.MiniGridState(jnp.asarray(pos), jnp.asarray(dirs),
                                          jnp.zeros((TREES, 1), bool), jnp.zeros(TREES, jnp.int32))
    states_t = torch_minigrid.MiniGridState(torch.tensor(pos, dtype=torch.int64),
                                            torch.tensor(dirs, dtype=torch.int64),
                                            torch.zeros((TREES, 1), dtype=torch.bool),
                                            torch.zeros(TREES, dtype=torch.int64))
    kw = dict(num_actions=3, episodes=episodes, horizon=horizon, gamma=0.8, threshold_coeff=4.0,
              continuation_uniform=True)
    keys = jax.random.split(jax.random.PRNGKey(11), TREES)
    draws, drops = olop_draws(keys, episodes, horizon, 3)
    jax_out = jax_olop_batch(env_j.functional, env_j.params, states_j, keys, **kw)
    launches = kl_module.kl_bound_indexed_.launches
    torch_out = torch_olop_batch(env_t.functional, env_t.params, states_t, random_actions=draws,
                                 env_noise=drops, device="cpu", **kw)
    assert kl_module.kl_bound_indexed_.launches == launches  # the plain version ran
    _assert_plans_match(jax_out, torch_out)
    tree = torch_out[2]
    # some paths reach the goal, whose reward comes with the terminating step:
    # OLOP zeroes a terminating step's reward in both packages
    # (rl_agents_tpu/agents/tree_search/olop.py:133-134), so no statistic holds it
    assert bool(tree.done.any()) and float(tree.cum_reward.abs().max()) == 0.0
    assert float(np.ptp(tree.mu_ucb[tree.count > 0].numpy())) > 0.05  # the KL solve did work


def test_kl_olop_agent_acts_as_the_jax_agent():
    """``kl-olop.json`` on ``empty.json``: the plan from the reset state, with
    the continuation drawn by each package's own generator, keeps the same
    allocation; from the start cell every continuation is rewardless, so the
    plan is the same."""
    config = json.loads((GRIDWORLD / "agents" / "kl-olop.json").read_text())
    env_t = load_environment(json.loads((GRIDWORLD / "empty.json").read_text()), device="cpu")
    env_j = jax_load_environment(json.loads((GRIDWORLD / "empty.json").read_text()))
    agent_t, agent_j = load_agent(config, env_t, device="cpu"), jax_load_agent(config, env_j)
    assert (agent_t.config["episodes"], agent_t.config["horizon"]) == \
        (agent_j.config["episodes"], agent_j.config["horizon"]) == (55, 9)
    obs_t, _ = env_t.reset(seed=0)
    obs_j, _ = env_j.reset(seed=0)
    for _ in range(2):
        action = agent_t.act(obs_t)
        assert action == agent_j.act(obs_j)
        obs_t, obs_j = env_t.step(action)[0], env_j.step(action)[0]
        np.testing.assert_array_equal(obs_t, np.asarray(obs_j))
