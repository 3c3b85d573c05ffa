"""The robust planners of the PyTorch port against the JAX package.

``robust_opd_plan`` plans B trees over M models at once; the JAX package's
is a single-tree program, so the port is held against ``jax.vmap`` of it
under the tie-breaking draws rebuilt from its keys, on the LOOP MDP of
``tests/agents/test_robust.py`` (with a degraded-reward model) and on
``merge-v0`` under the Aggressive and Defensive presets. Actions, lengths,
every integer field, the bounds and the arena's env states are equal bit for
bit."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_opd import _chain_noise

from rl_agents_torch.agents.robust import robust as tr
from rl_agents_torch.agents.tree_search import batch as tb
from rl_agents_torch.agents.tree_search import deterministic as td
from rl_agents_torch.convert import (from_numpy, highway_state_from_numpy,
                                     robust_tree_from_numpy, tree_to_numpy)
from rl_agents_torch.envs import finite_mdp as tm
from rl_agents_torch.envs import highway as th
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_tpu.agents.robust import robust as jr
from rl_agents_tpu.envs import finite_mdp as jm
from rl_agents_tpu.envs import highway as jh
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "scripts" / "configs"
LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]], "terminal": [0, 0, 0, 0],
        "max_episode_steps": 1000}
PRESETS = ("highway_env.vehicle.behavior.AggressiveVehicle",
           "highway_env.vehicle.behavior.DefensiveVehicle")
EXACT = ("parent", "action", "depth", "children", "done", "leaf", "used")
BOUNDS = ("reward", "value_lower", "value_upper")
M = 2


def _loop_case():
    env_j, p1 = jm.params_from_config(LOOP)
    ensemble_j = jax.tree.map(lambda a, b: jnp.stack([a, b]), p1,
                              p1._replace(reward=p1.reward * 0.5))
    B = 6
    s = np.random.default_rng(0).integers(0, 4, B).astype(np.int32)
    states_j = jm.MDPState(s=np.repeat(s[:, None], M, 1), t=np.zeros((B, M), np.int32),
                           done=np.zeros((B, M), bool))
    env_t = tm.FiniteMDPEnv(4, 3, max_episode_steps=1000)
    return (env_j, ensemble_j, jax.tree.map(jnp.asarray, states_j)), \
        (env_t, from_numpy(tm.MDPParams, jax.tree.map(np.asarray, ensemble_j), device="cpu"),
         from_numpy(tm.MDPState, states_j, device="cpu")), \
        dict(num_actions=3, num_models=M, expansions=20, gamma=0.8, plan_capacity=20), tm.MDPState


def _merge_case():
    handle_j = jh.make({"id": "merge-v0"})
    env_j = handle_j.functional
    variants = [env_j.preprocess("change_vehicles", spec)[1](handle_j.params, None)[0]
                for spec in PRESETS]
    ensemble_j = jax.tree.map(lambda a, b: jnp.stack([a, b]), *variants)
    B = 4
    states, _ = jax.vmap(env_j.reset, in_axes=(None, 0))(
        handle_j.params, jax.random.split(jax.random.PRNGKey(0), B))
    states_j = jax.tree.map(lambda x: jnp.repeat(x[:, None], M, 1), states)
    env_t = th.make({"id": "merge-v0"}, device="cpu").functional
    return (env_j, ensemble_j, states_j), \
        (env_t, from_numpy(th.HighwayParams, jax.tree.map(np.asarray, ensemble_j), device="cpu"),
         highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")), \
        dict(num_actions=5, num_models=M, expansions=8, gamma=0.9, terminal_reward=-1.0,
             plan_capacity=8), th.HighwayState


CASES = {"loop_mdp": _loop_case, "merge_two_presets": _merge_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def planned(request):
    (env_j, ensemble_j, states_j), (env_t, ensemble_t, states_t), plan, state_cls = \
        CASES[request.param]()
    B = states_t[0].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    out_j = jax.vmap(lambda s, k: jr.robust_opd_plan(env_j, ensemble_j, s, k, **plan))(
        states_j, keys)
    noise = _chain_noise(keys, plan["plan_capacity"], plan["num_actions"])
    out_t = tr.robust_opd_plan(env_t, ensemble_t, states_t, None, noise=noise, device="cpu",
                               **plan)
    return request.param, out_j, out_t, (env_t, ensemble_t, states_t, noise), plan, state_cls


def test_robust_opd_plan_matches_jax_vmap(planned):
    _, (actions_j, lengths_j, tree_j), (actions_t, lengths_t, tree_t), *_ = planned
    np.testing.assert_array_equal(actions_t.numpy(), np.asarray(actions_j))
    np.testing.assert_array_equal(lengths_t.numpy(), np.asarray(lengths_j))
    got = tree_to_numpy(tree_t)
    for field in EXACT + BOUNDS:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                      err_msg=field)
    allocated = np.asarray(tree_j.parent) >= 0
    allocated[:, 0] = True
    for arena_t, arena_j in zip(got.states, tree_j.states):
        np.testing.assert_array_equal(arena_t[allocated], np.asarray(arena_j)[allocated])
    assert (lengths_t >= 1).all()


def test_backup_broadcasts_the_worst_model_into_every_row(planned):
    """An interior node holds the max over its children of the min over
    models in every model's row; the plan reads it (robust.py:112-136)."""
    _, _, (_, _, tree), *_ = planned
    interior = (tree.children >= 0).any(dim=2)
    rows = tree.value_lower[interior]
    assert (rows == rows[:, :1]).all() and interior.sum() > 0
    leaves = tree.value_lower[tree.leaf]
    assert (leaves[:, 0] != leaves[:, 1]).any()  # the models disagree at the leaves


def test_robust_tree_converts_and_the_batch_entry_plans_alike(planned):
    name, (_, _, tree_j), (actions_t, _, tree_t), (env_t, ensemble_t, states_t, noise), plan, \
        state_cls = planned
    converted = robust_tree_from_numpy(jax.tree.map(np.asarray, tree_j), state_cls, device="cpu")
    for a, b in zip(tree_to_numpy(converted), tree_to_numpy(tree_t)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    actions, _, _ = tb.robust_opd_plan_batch(env_t, ensemble_t, states_t, noise=noise,
                                             device="cpu", **plan)
    assert torch.equal(actions, actions_t)


def test_robust_opd_lower_bounds_nominal():
    """The property of ``tests/agents/test_robust.py``: robust OPD over an
    ensemble holding the nominal model is at most the nominal OPD value."""
    env, p1 = tm.params_from_config(LOOP, device="cpu")
    ensemble = tr.stack_params([p1, p1._replace(reward=p1.reward * 0.5)])
    state = tm.MDPState(s=torch.zeros(1, dtype=torch.int64), t=torch.zeros(1, dtype=torch.int64),
                        done=torch.zeros(1, dtype=torch.bool))
    states0 = tm.MDPState(*(x[:, None].expand(1, M) for x in state))
    gen = torch.Generator().manual_seed(0)
    _, len_r, tree_r = tr.robust_opd_plan(env, ensemble, states0, gen, num_actions=3,
                                          num_models=M, expansions=20, gamma=0.8, device="cpu")
    _, _, tree_n = td.opd_plan(env, p1, state, gen, num_actions=3, expansions=20, gamma=0.8,
                               device="cpu")
    assert float(tree_r.value_lower[0, 0].min()) <= float(tree_n.value_lower[0, 0]) + 1e-5
    assert int(len_r[0]) >= 1


def test_needs_a_generator_or_noise():
    _, (env_t, ensemble_t, states_t), plan, _ = _loop_case()
    with pytest.raises(ValueError, match="generator or noise"):
        tr.robust_opd_plan(env_t, ensemble_t, states_t, None, device="cpu", **plan)


def test_drop_agent_on_merge_stacks_the_config_presets():
    """``MergeEnv/agents/DiscreteRobustPlannerAgent.json`` lists each model as
    a bare preprocessor config; the port takes it as a one-item list (the JAX
    agent iterates the dict's keys and fails)."""
    config = CONFIGS / "MergeEnv" / "agents" / "DiscreteRobustPlannerAgent.json"
    env = load_environment(CONFIGS / "MergeEnv" / "env.json", device="cpu")
    agent = load_agent(config, env, device="cpu")
    ensemble = agent.ensemble(env)
    handle_j = jax_load_environment(str(CONFIGS / "MergeEnv" / "env.json"))
    for m, spec in enumerate(PRESETS):
        want = handle_j.preprocess("change_vehicles", spec).params
        for name in want._fields:
            np.testing.assert_array_equal(getattr(ensemble, name)[m].numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    agent.seed(0)
    assert agent.act(env.reset(seed=0)[0]) in range(5)
    assert agent.last_plan_data.value_lower.shape == (1, 1 + 40 * 5, M)
    jax_agent = jax_load_agent(str(config), handle_j)
    with pytest.raises(TypeError):
        jax_agent.act(handle_j.reset(seed=0)[0])


def test_drop_agent_lane_change_config_keeps_its_no_op_models():
    """``HighwayEnv/agents/DiscreteRobustPlannerAgent/lane_change.json``: its
    ``set_preferred_lane`` preprocessors are no-ops on the surrogate, as in
    JAX, so both models are the nominal params."""
    config = CONFIGS / "HighwayEnv" / "agents" / "DiscreteRobustPlannerAgent" / "lane_change.json"
    env = load_environment(CONFIGS / "HighwayEnv" / "env.json", device="cpu")
    agent = load_agent(config, env, device="cpu")
    handle_j = jax_load_environment(str(CONFIGS / "HighwayEnv" / "env.json"))
    ensemble_j = jax_load_agent(str(config), handle_j).ensemble(handle_j)
    ensemble = agent.ensemble(env)
    for name in ensemble_j._fields:
        np.testing.assert_array_equal(getattr(ensemble, name).numpy(),
                                      np.asarray(getattr(ensemble_j, name)), err_msg=name)
    assert ensemble.idm_a.shape == (2,)
    assert agent.act(env.reset(seed=0)[0]) in range(5)


def test_irp_agent_delegates_to_its_sub_agent_through_the_factory():
    config = json.loads((CONFIGS / "HighwayEnv" / "agents" / "IntervalRobustPlannerAgent" /
                         "baseline.json").read_text())
    env = load_environment(CONFIGS / "HighwayEnv" / "env.json", device="cpu")
    agent = load_agent(config, env, device="cpu")
    assert type(agent.sub_agent).__name__ == "DeterministicPlannerAgent"
    assert agent.sub_agent.config["budget"] == 35  # opd.json, resolved against scripts/
    agent.seed(0)
    obs, _ = env.reset(seed=0)
    for _ in range(2):
        action = agent.act(obs)
        assert action in range(5)
        obs, *_ = env.step(action)
    # simplify, then change_vehicles with a preset the surrogate does not know
    assert agent.sub_agent.env.functional.vehicles == 6
    for a, b in zip(agent.sub_agent.env.params, env.params):
        assert torch.equal(a, b)
    assert env.functional.vehicles == 15
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_agent(config, env)


@pytest.mark.parametrize("env_config,agent_config", [
    ("HighwayEnv/env.json", "HighwayEnv/agents/DeterministicPlannerAgent.json"),
    ("HighwayEnv/env.json", "HighwayEnv/agents/IntervalRobustPlannerAgent/baseline.json"),
    ("MergeEnv/env.json", "MergeEnv/agents/DiscreteRobustPlannerAgent.json"),
])
def test_cli_runs_the_highway_planners_on_the_cpu(tmp_path, env_config, agent_config):
    """The corpus lines through ``python -m rl_agents_torch.experiments``, the
    episode cut to 4 steps."""
    env_path, out = tmp_path / "env.json", tmp_path / "out"
    env_path.write_text(json.dumps(dict(json.loads((CONFIGS / env_config).read_text()),
                                        duration=4)))
    proc = subprocess.run(
        [sys.executable, "-m", "rl_agents_torch.experiments", "evaluate", str(env_path),
         str(CONFIGS / agent_config), "--test", "--episodes", "1", "--seed", "0", "--device",
         "cpu", "--directory", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    runs = list(out.glob("run_*"))
    episodes = [json.loads(line) for line in (runs[0] / "episodes.jsonl").read_text().splitlines()]
    assert len(episodes) == 1 and 1 <= episodes[0]["length"] <= 4
    assert np.isfinite(episodes[0]["total_reward"])
