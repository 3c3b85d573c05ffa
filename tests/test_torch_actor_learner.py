"""The fused actor-learner of the PyTorch port against the JAX package's
``make_actor_learner`` on CartPole, with every draw injected.

JAX draws a step's randomness from ``split(state.key, 5)`` (the random
actions, the env steps, the epsilon tests, the resets) and then
``split(key)`` for the minibatch; the test replays that chain with
``jax.random`` and hands the same numbers to the port as ``SegmentDraws``.
The actions, rewards and terminals in the ring, ``position``, ``size``,
``time``, ``completed_count``, ``episode_return`` and ``completed_return``
must then be equal, and the ring's states within ``STATE_TOL``. The
parameters and the target are held to ``PARAM_ATOL`` = 1e-6 absolute: torch
and XLA round the matmuls and reductions of the gradient differently (about
1e-7 relative), and ADAM's step is a ratio of moments of the same gradients,
near ``lr * sign(g)`` in its first steps, so a difference stays at rounding
size unless a gradient entry sits at zero. The largest difference measured
on these cases is 3.0e-08 after 16 updates at lr 5e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_agents_torch.convert import flax_params_to_torch, torch_params_to_flax
from rl_agents_torch.envs.cartpole import CartPoleEnv as TorchCartPole
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.models.optimizers import optimizer_factory
from rl_agents_torch.models.zoo import MultiLayerPerceptron as TorchMLP
from rl_agents_torch.parallel.actor_learner import (
    SegmentDraws,
    make_actor_learner as torch_actor_learner,
    train_dqn_fused as torch_train_dqn_fused,
)
from rl_agents_torch.trainer.evaluation import Evaluation
from rl_agents_tpu.envs.cartpole import CartPoleEnv as JaxCartPole
from rl_agents_tpu.models import MultiLayerPerceptron as JaxMLP
from rl_agents_tpu.parallel.actor_learner import make_actor_learner as jax_actor_learner

torch.set_num_threads(1)

E = 8
STEPS = 20
PARAM_ATOL = 1e-6
# JAX compiles the env's default params into the fused program as constants,
# and XLA folds CartPole's divisions by them into multiplications by the
# reciprocal (x / 1.1 -> x * 0.909090877); the port steps the env with its
# params as tensors, as every planner does, so the ring's float states differ
# by ulps (ROADMAP.md, faults within tolerance)
STATE_TOL = dict(rtol=1e-6, atol=1e-6)
LEARNER = dict(num_envs=E, capacity=96, batch_size=16, gamma=0.99, double=True,
               target_update=5, eps_init=1.0, eps_final=0.1, eps_tau=10.0,
               learning_starts=32)


def _jax_draws(key, steps, size0, capacity, batch_size, updates_per_step, sample_mode):
    """Rebuild the draws of ``steps`` JAX steps from the state's key."""
    explore, actions, resets, samples = [], [], [], []
    env = JaxCartPole()
    size = size0
    for _ in range(steps):
        key, ka, ks, kr, kb = jax.random.split(key, 5)
        actions.append(np.asarray(jax.random.randint(ka, (E,), 0, 2)))
        explore.append(np.asarray(jax.random.uniform(kr, (E,))))
        _, reset_obs = jax.vmap(env.reset, in_axes=(None, 0))(
            env.default_params(), jax.random.split(kb, E))
        resets.append(np.asarray(reset_obs))
        size = min(size + E, capacity)
        key, km = jax.random.split(key)
        kus = [km] if updates_per_step == 1 else list(jax.random.split(km, updates_per_step))
        if sample_mode == "slices":
            rows = [np.asarray(jax.random.randint(k, (batch_size // E,), 0, max(size // E, 1)))
                    for k in kus]
        else:
            rows = [np.asarray(jax.random.randint(k, (batch_size,), 0, max(size, 1)))
                    for k in kus]
        samples.append(np.stack(rows))
    return SegmentDraws(torch.tensor(np.stack(explore)),
                        torch.tensor(np.stack(actions), dtype=torch.int64),
                        torch.tensor(np.stack(resets)),
                        torch.tensor(np.stack(samples), dtype=torch.int64))


def _run_both(layers=(16, 16), updates_per_step=1, n_steps=1, sample_mode="uniform", seed=3,
              **overrides):
    config = dict(LEARNER, n_steps=n_steps, updates_per_step=updates_per_step,
                  sample_mode=sample_mode, **overrides)
    env_j = JaxCartPole(max_episode_steps=30)
    model_j = JaxMLP(layers=layers, out=2)
    init_j, segment_j = jax_actor_learner(env_j, model_j, optax.adam(5e-4), **config)
    state_j = init_j(jax.random.PRNGKey(seed))
    params0 = jax.tree.map(np.asarray, state_j.params)
    obs0 = np.asarray(state_j.obs)
    draws = _jax_draws(state_j.key, STEPS, 0, config["capacity"], config["batch_size"],
                       updates_per_step, sample_mode)
    state_j, reward_j = segment_j(state_j, steps=STEPS)

    model_t = TorchMLP(4, layers, out=2)
    flax_params_to_torch(model_t, params0)
    init_t, segment_t = torch_actor_learner(TorchCartPole(max_episode_steps=30), model_t,
                                            optimizer_factory("ADAM", lr=5e-4), device="cpu",
                                            **config)
    generator = torch.Generator().manual_seed(0)
    state_t = init_t(generator, params=dict(model_t.named_parameters()),
                     reset_noise=torch.tensor(obs0))
    state_t, reward_t = segment_t(state_t, steps=STEPS, draws=draws)
    return state_j, reward_j, state_t, reward_t, model_t


def _flat_params(params_t, model_t, params_j):
    """The port's parameter dict and JAX's tree as two lists of flax-layout
    arrays, in the same order."""
    with torch.no_grad():
        for name, p in model_t.named_parameters():
            p.copy_(params_t[name])
    ported = jax.tree_util.tree_leaves(torch_params_to_flax(model_t))
    return ported, jax.tree_util.tree_leaves(jax.tree.map(np.asarray, params_j))


def _check(state_j, reward_j, state_t, reward_t, model_t):
    buf_j, buf_t = state_j.buffer, state_t.buffer
    np.testing.assert_array_equal(buf_t.action.numpy(), np.asarray(buf_j.action))
    np.testing.assert_array_equal(buf_t.reward.numpy(), np.asarray(buf_j.reward))
    np.testing.assert_array_equal(buf_t.terminal.numpy(), np.asarray(buf_j.terminal))
    np.testing.assert_allclose(buf_t.state.numpy(), np.asarray(buf_j.state), **STATE_TOL)
    np.testing.assert_allclose(buf_t.next_state.numpy(), np.asarray(buf_j.next_state),
                               **STATE_TOL)
    for field in ("position", "size", "time", "completed_count"):
        assert int(getattr(state_t, field)) == int(getattr(state_j, field)), field
    assert float(state_t.completed_return) == float(state_j.completed_return)
    np.testing.assert_array_equal(state_t.episode_return.numpy(),
                                  np.asarray(state_j.episode_return))
    np.testing.assert_allclose(state_t.obs.numpy(), np.asarray(state_j.obs), **STATE_TOL)
    assert float(reward_t) == pytest.approx(float(reward_j), abs=1e-6)
    assert int(state_t.opt_state["count"]) == int(state_j.opt_state[0].count)
    for params_t, params_j in ((state_t.params, state_j.params),
                               (state_t.target_params, state_j.target_params)):
        ported, reference = _flat_params(params_t, model_t, params_j)
        for a, b in zip(ported, reference):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_twenty_steps_equal_jax_with_injected_draws():
    state_j, reward_j, state_t, reward_t, model_t = _run_both()
    assert int(state_t.completed_count) > 0  # episodes ended and were reset
    assert int(state_t.size) == 96 and int(state_t.position) == 160 % 96  # the ring wrapped
    # updates are kept from the step at which the ring holds learning_starts rows
    assert int(state_t.opt_state["count"]) == STEPS - LEARNER["learning_starts"] // E + 1
    _check(state_j, reward_j, state_t, reward_t, model_t)


def test_n_step_stride_path_equals_jax():
    _check(*_run_both(n_steps=3))


def test_slices_sampling_equals_jax():
    _check(*_run_both(sample_mode="slices"))


def test_two_updates_per_step_equal_jax():
    _check(*_run_both(updates_per_step=2))


def test_non_double_target_equals_jax():
    _check(*_run_both(double=False))


@pytest.mark.parametrize("bad", [dict(batch_size=12), dict(capacity=100), dict(n_steps=2)])
def test_slices_sampling_refuses_a_misaligned_ring(bad):
    config = dict(LEARNER, sample_mode="slices")
    config.update(bad)
    with pytest.raises(ValueError, match="slices sampling"):
        torch_actor_learner(TorchCartPole(), TorchMLP(4, (8,), out=2),
                            optimizer_factory("ADAM"), device="cpu", **config)
    with pytest.raises(ValueError, match="slices sampling"):
        jax_actor_learner(JaxCartPole(), JaxMLP(layers=(8,), out=2), optax.adam(5e-4), **config)


def test_generated_draws_train_and_keep_the_ring_consistent():
    state, history = torch_train_dqn_fused(
        TorchCartPole(max_episode_steps=50), TorchMLP(4, (16, 16), out=2), total_steps=60,
        segment=20, seed=0, num_envs=E, capacity=128, batch_size=16, learning_starts=16,
        device="cpu")
    assert len(history) == 3 and all(np.isfinite(history))
    assert int(state.time) == 60 and int(state.size) == 128
    assert int(state.position) == 60 * E % 128
    assert set(state.buffer.action.unique().tolist()) <= {0, 1}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_actor_learner(TorchCartPole(), TorchMLP(4, (8,), out=2), optimizer_factory("ADAM"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_train_dqn_fused(TorchCartPole(), TorchMLP(4, (8,), out=2), total_steps=1,
                              segment=1)


def test_fused_training_via_harness(tmp_path):
    """``"fused": true`` through ``Evaluation.train()``, as
    tests/test_fused_training_path.py drives the JAX package, at a CPU size."""
    config = {"__class__": "DQNAgent", "fused": True, "fused_envs": 16,
              "model": {"type": "MultiLayerPerceptron", "layers": [32, 32]},
              "exploration": {"tau": 500}, "target_update": 50, "memory_capacity": 5000}
    env = load_environment({"id": "cartpole", "max_episode_steps": 100}, device="cpu")
    agent = load_agent(config, env, device="cpu")
    before = agent.train_state.params["Dense_0.weight"].clone()
    evaluation = Evaluation(env, agent, directory=tmp_path, num_episodes=40, training=True,
                            sim_seed=0)
    evaluation.train()
    after = agent.train_state.params["Dense_0.weight"]
    assert not torch.allclose(after, before)
    assert agent.steps == 40 * 100 // 16
    target = agent.train_state.target_params["Dense_0.weight"]
    assert not torch.allclose(target, before)
    assert (evaluation.run_directory / "checkpoint-final.tar").is_file()
    assert (tmp_path / "saved_models" / "latest.tar").is_file()
    agent.eval()
    obs, _ = env.reset(seed=3)
    for _ in range(20):
        obs, reward, terminal, truncated, _ = env.step(agent.act(obs))
        if terminal or truncated:
            break
    assert np.all(np.isfinite(agent.get_state_action_values(obs)))
