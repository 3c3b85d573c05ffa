"""The linear plants of the PyTorch port against the JAX package:
``linear-system`` (nominal and its robust variant with the interval predictor)
and ``lane-keeping-v0``, 40-step rollouts under JAX's replayed omega draws,
bit-equal; and the env handle's dict observations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.envs import linear as torch_linear
from rl_agents_torch.factory import load_environment
from rl_agents_torch.utils.noise import threefry_uniform
from rl_agents_tpu.envs import linear as jax_linear
from test_torch_small_envs import STEPS, ROWS, discrete_actions, raw, rollout

torch.set_num_threads(1)

A0 = np.array([[0.0, 1.0], [0.0, -0.4]], np.float32)
DA = np.array([[[0.0, 0.0], [0.0, -0.1]], [[0.0, 0.0], [0.0, 0.1]]], np.float32)


def omega_draws(keys):
    return np.array([threefry_uniform(raw(k), (1,), -1.0, 1.0) for k in keys], np.float32)


def test_linear_system_rollouts_are_bit_equal_under_jax_draws():
    config = {"omega_bound": 0.2, "theta": [0.3]}
    env_j, env_t = jax_linear.make(config), torch_linear.make(config, device="cpu")
    state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params,
                    discrete_actions(2), step_noise=omega_draws)
    assert torch.equal(state.x_lo, state.x) and torch.equal(state.x_hi, state.x)


def test_robust_variant_rollouts_are_bit_equal_under_jax_draws():
    config = {"omega_bound": 0.2}
    env_j, env_t = jax_linear.make(config), torch_linear.make(config, device="cpu")
    robust_j, robust_t = env_j.functional.robust_variant(2), env_t.functional.robust_variant(2)
    params_j = env_j.params._replace(lpv_a0=jnp.asarray(A0), lpv_da=jnp.asarray(DA),
                                     omega_lo=jnp.asarray([-0.01]), omega_hi=jnp.asarray([0.01]))
    params_t = env_t.params._replace(lpv_a0=torch.tensor(A0), lpv_da=torch.tensor(DA),
                                     omega_lo=torch.tensor([-0.01]), omega_hi=torch.tensor([0.01]))
    state = rollout(robust_j, params_j, robust_t, params_t, discrete_actions(2, seed=4),
                    step_noise=omega_draws)
    assert (state.x_hi - state.x_lo).min() > 0  # the interval has grown


def test_lane_keeping_rollouts_are_bit_equal_under_jax_draws():
    env_j = jax_linear.make_lane_keeping({"omega_bound": 0.1})
    env_t = torch_linear.make_lane_keeping({}, device="cpu")
    params_j = env_j.params._replace(omega_bound=jnp.float32(0.1))
    params_t = env_t.params._replace(omega_bound=torch.tensor(0.1))
    controls = np.random.default_rng(2).uniform(-1.5, 1.5, (STEPS, ROWS, 1)).astype(np.float32)
    rollout(env_j.functional, params_j, env_t.functional, params_t, controls,
            step_noise=omega_draws)


def test_handle_returns_the_dict_observation_and_the_constraint():
    env_j = jax_linear.make({"max_episode_steps": 30, "x_limit": 1.05})
    env_t = torch_linear.make({"max_episode_steps": 30, "x_limit": 1.05}, device="cpu")
    obs_j, _ = env_j.reset(seed=0)
    obs_t, _ = env_t.reset(seed=0)
    assert set(obs_t) == set(obs_j)
    for _ in range(12):
        out_j, out_t = env_j.step(0), env_t.step(0)
        for k in obs_t:
            np.testing.assert_array_equal(out_t[0][k], out_j[0][k])
        assert out_t[1:4] == out_j[1:4]
        assert float(out_t[4]["constraint"]) == float(out_j[4]["constraint"])
    assert float(out_t[4]["constraint"]) == 1.0


def test_null_noise_is_the_draw_of_jax_all_zero_key():
    draw = jax.random.uniform(jnp.zeros((2,), jnp.uint32), (1,), minval=-1.0, maxval=1.0)
    got = torch_linear.LinearSystemEnv().null_noise(3, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(draw), (3, 1)))


def test_makes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for env_id in ("linear-system", "lane-keeping-v0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_environment({"id": env_id})
