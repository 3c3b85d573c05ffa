"""Fitted-Q iteration in the PyTorch port against the JAX package: one
regression epoch and a whole ``update()`` under the minibatch indices and
initial parameters that the JAX agent's own keys draw, the epoch count, the
batched episodes of ``Evaluation.train()`` on CartPole, and the memory saved
beside the model as ``.data``.

Parameters agree within 1e-5 of each leaf's largest entry (float rounding of
the gradients, carried through the ADAM steps)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.fitted_q import MINIBATCH
from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.factory import load_agent as torch_load_agent
from rl_agents_torch.factory import load_agent_config
from rl_agents_torch.factory import load_environment as torch_load_environment
from rl_agents_torch.trainer.evaluation import Evaluation as TorchEvaluation
from rl_agents_torch.utils.math import near_split
from rl_agents_tpu.factory import load_agent as jax_load_agent
from rl_agents_tpu.factory import load_environment as jax_load_environment
from rl_agents_tpu.trainer.evaluation import Evaluation as JaxEvaluation
from rl_agents_tpu.utils.math import near_split as jax_near_split

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
REL = 1e-5


def _config(**over):
    config = load_agent_config(CONFIGS / "CartPoleEnv" / "FTQAgent.json")
    config["model"]["layers"] = [32, 32]
    config.update(over)
    return config


def _agents(config):
    env_j = jax_load_environment(CONFIGS / "CartPoleEnv" / "env.json")
    env_t = torch_load_environment(CONFIGS / "CartPoleEnv" / "env.json", device="cpu")
    return (jax_load_agent(json.loads(json.dumps(config)), env_j),
            torch_load_agent(json.loads(json.dumps(config)), env_t, device="cpu"))


def _fill(agents, count, seed):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        s, ns = rng.normal(size=4).astype(np.float32), rng.normal(size=4).astype(np.float32)
        args = (s, int(rng.integers(0, 2)), float(rng.random()), ns, bool(rng.random() < 0.1), {})
        for agent in agents:
            agent.record(*args)


def _to_torch(agent_t, params):
    flax_params_to_torch(agent_t.model, jax.tree.map(np.asarray, params))
    return {k: v.detach().clone() for k, v in agent_t.model.named_parameters()}


def _assert_close(agent_t, params_t, params_j):
    with torch.no_grad():
        for name, p in agent_t.model.named_parameters():
            p.copy_(params_t[name])
    got = jax.tree_util.tree_leaves(torch_params_to_flax(agent_t.model))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, params_j))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())


def _epoch_indices(key, steps, size):
    """The minibatch indices of one JAX epoch (fitted_q.py:52,60)."""
    return np.stack([np.asarray(jax.random.randint(k, (MINIBATCH,), 0, size))
                     for k in jax.random.split(key, steps)])


def test_one_epoch_matches_jax_under_its_indices():
    agent_j, agent_t = _agents(_config(regression_epochs=12))
    _fill((agent_j, agent_t), 150, seed=1)
    assert len(agent_t.memory) == len(agent_j.memory) == 150
    target_j = jax.tree.map(lambda p: p * 0.9 + 0.01, agent_j.train_state.params)
    params_t, target_t = _to_torch(agent_t, agent_j.train_state.params), _to_torch(agent_t,
                                                                                 target_j)
    key = jax.random.PRNGKey(3)
    params_j, _, losses_j = agent_j._epoch(agent_j.train_state.params, target_j,
                                           agent_j.train_state.opt_state, agent_j.memory.data,
                                           agent_j.memory.size, key)
    params_out, opt_state, losses_t = agent_t._epoch(
        params_t, target_t, agent_t.optimizer.init(list(params_t.values())), agent_t.memory.data,
        agent_t.memory.size, None, indices=_epoch_indices(key, 12, 150))
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=REL)
    assert int(opt_state["count"]) == 12
    _assert_close(agent_t, params_out, params_j)


@pytest.mark.parametrize("gamma,epochs,want", [(0.8, None, 15), (0.9, "from-gamma", 30),
                                               (0.9, 4, 4), (0.5, 0, 6)])
def test_value_iteration_epoch_count(gamma, epochs, want):
    agent_j, agent_t = _agents(_config(gamma=gamma, value_iteration_epochs=epochs,
                                       regression_epochs=1))
    assert agent_t.value_iteration_epochs == want
    _fill((agent_t,), 70, seed=2)
    calls = []
    epoch = agent_t._epoch
    agent_t._epoch = lambda *a, **k: calls.append(1) or epoch(*a, **k)
    agent_t.update()
    assert len(calls) == want


def test_update_matches_jax_under_its_keys():
    """A whole ``update()``: the JAX agent draws N + 1 initial parameter sets
    and N epochs of indices from its key; the port is given the same."""
    agent_j, agent_t = _agents(_config(gamma=0.5, value_iteration_epochs=3, regression_epochs=6))
    _fill((agent_j, agent_t), 90, seed=4)
    key = agent_j.key
    model, dummy = agent_j.model, jnp.zeros((1, 4), jnp.float32)
    inits, indices = [], []
    key, sub = jax.random.split(key)
    inits.append(model.init(sub, dummy))
    for _ in range(3):
        key, sub = jax.random.split(key)
        inits.append(model.init(sub, dummy))
        key, sub = jax.random.split(key)
        indices.append(_epoch_indices(sub, 6, 90))
    agent_j.update()
    agent_t.update(indices=indices, init_params=[_to_torch(agent_t, p) for p in inits])
    _assert_close(agent_t, agent_t.train_state.params, agent_j.train_state.params)
    _assert_close(agent_t, agent_t.train_state.target_params, agent_j.train_state.target_params)


def test_batched_episodes_through_train_on_cartpole(tmp_path):
    """``Evaluation.train()`` routes the batched agent into batched episodes:
    ``near_split(num_episodes * 14, size_bins=batch_size)`` samples, batch 0
    collected by pure exploration from the same numpy stream as JAX's, and
    one ``update()`` per batch; the final checkpoint carries the memory."""
    config = _config(regression_epochs=4, value_iteration_epochs=2, batch_size=20)
    agent_j, agent_t = _agents(config)
    assert agent_t.batched and agent_j.batched
    assert near_split(5 * 14, size_bins=20) == jax_near_split(5 * 14, size_bins=20) == \
        [18, 18, 17, 17]
    updates = []
    update = agent_t.update
    agent_t.update = lambda: updates.append(len(agent_t.memory)) or update()
    torch_run = TorchEvaluation(agent_t.env, agent_t, directory=tmp_path / "torch",
                                num_episodes=5, training=True, sim_seed=0)
    jax_run = JaxEvaluation(agent_j.env, agent_j, directory=tmp_path / "jax", num_episodes=5,
                            training=True, sim_seed=0)
    torch_run.train()
    jax_run.train()
    assert updates == [18, 36, 53, 70] and len(agent_t.memory) == len(agent_j.memory) == 70
    # batch 0 explores only: the same actions from the same seed
    np.testing.assert_array_equal(agent_t.memory.data.action[:18].numpy(),
                                  np.asarray(agent_j.memory.data.action[:18]))
    assert agent_t.exploration_policy.config == agent_j.exploration_policy.config
    final = torch_run.run_directory / "checkpoint-final.tar"
    assert final.is_file() and final.with_suffix(".data").is_file()
    fresh = torch_load_agent(json.loads(json.dumps(config)), agent_t.env, device="cpu")
    fresh.load(final)
    assert len(fresh.memory) == 70 and fresh.memory.position == agent_t.memory.position
    for field in ("state", "action", "reward", "next_state", "terminal"):
        assert torch.equal(getattr(fresh.memory.data, field), getattr(agent_t.memory.data, field))
    for name, value in agent_t.train_state.params.items():
        assert torch.equal(fresh.train_state.params[name], value)


def test_record_stores_only_and_folds_the_constraint_penalty():
    agent_j, agent_t = _agents(_config(constraint_penalty=-2.0))
    args = (np.zeros(4, np.float32), 1, 1.0, np.ones(4, np.float32), False, {"constraint": 0.5})
    for agent in (agent_j, agent_t):
        agent.record(*args)
    assert len(agent_t.memory) == 1 and agent_t.steps == 0
    assert float(agent_t.memory.data.reward[0]) == float(agent_j.memory.data.reward[0]) == 0.0
    agent_t.eval()
    agent_t.record(*args)
    assert len(agent_t.memory) == 1
