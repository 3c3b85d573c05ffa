"""The host gymnasium bridge of the PyTorch port against the JAX package's:
``load_environment`` sends an id that no functional env serves to it, as
JAX's does (rl_agents_tpu/factory.py:160-163), and on gymnasium's
``CartPole-v1`` one seeded episode is equal step for step, forks included."""
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from rl_agents_torch.envs.bridge import GymBridge  # noqa: E402
from rl_agents_torch.factory import load_environment  # noqa: E402
from rl_agents_tpu.factory import load_environment as jax_load_environment  # noqa: E402

torch.set_num_threads(1)


def test_an_unregistered_id_goes_to_the_bridge():
    env = load_environment({"id": "CartPole-v1"}, device="cpu")
    assert isinstance(env, GymBridge) and env.unwrapped.spec.id == "CartPole-v1"
    assert type(jax_load_environment({"id": "CartPole-v1"})).__name__ == "GymBridge"


def test_seeded_episode_equals_the_jax_bridge():
    env_t = load_environment({"id": "CartPole-v1"}, device="cpu")
    env_j = jax_load_environment({"id": "CartPole-v1"})
    obs_t, _ = env_t.reset(seed=3)
    obs_j, _ = env_j.reset(seed=3)
    np.testing.assert_array_equal(obs_t, obs_j)
    actions = np.random.default_rng(0).integers(0, 2, 500)
    steps = 0
    for action in actions:
        out_t, out_j = env_t.step(int(action)), env_j.step(int(action))
        np.testing.assert_array_equal(out_t[0], out_j[0])
        assert out_t[1:4] == out_j[1:4]
        steps += 1
        if out_t[2] or out_t[3]:
            break
    assert out_t[2] and steps < 500  # the random policy drops the pole


def test_fork_is_an_independent_copy():
    env = load_environment({"id": "CartPole-v1"}, device="cpu")
    env.reset(seed=1)
    fork = env.fork()
    out_fork = fork.step(1)
    out_env = env.step(1)
    np.testing.assert_array_equal(out_fork[0], out_env[0])
    fork.step(0)
    assert not np.array_equal(fork.unwrapped.state, env.unwrapped.state)


def test_unknown_preprocessor_is_a_no_op():
    env = load_environment({"id": "CartPole-v1"}, device="cpu")
    assert env.preprocess("no_such_method", ()) is env


def test_an_unknown_gym_id_raises_gymnasium_error():
    with pytest.raises(gym.error.Error):
        load_environment({"id": "no-such-env-v0"}, device="cpu")
