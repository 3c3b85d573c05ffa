"""The Sailing domain of the PyTorch port against the JAX package: the same
states and actions, made from a seed with numpy, and the JAX package's own
uniform draws rebuilt from its keys and injected as ``noise``. Integer state
fields and flags are equal; rewards, costs and observations agree within 1e-6
(one float32 division each)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.convert import from_numpy
from rl_agents_torch.envs import sailing as torch_sailing
from rl_agents_torch.ops.hashing import obs_key as torch_obs_key
from rl_agents_tpu.envs import sailing as jax_sailing
from rl_agents_tpu.ops.hashing import obs_key as jax_obs_key

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs" / "SailingEnv"
ATOL = 1e-6


def _jax_uniforms(keys):
    """The draw of each step key (rl_agents_tpu/envs/sailing.py:89-90)."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0]))(keys))


def _states(size, batch, seed, max_steps):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, size, (batch, 2)).astype(np.int32)
    pos[: batch // 4] = np.maximum(pos[: batch // 4], size - 2)  # next to the goal
    pos[batch // 4: batch // 2] = np.minimum(pos[batch // 4: batch // 2], 1)  # at the border
    return jax_sailing.SailingState(
        pos=pos, wind=rng.integers(0, 8, batch).astype(np.int32),
        t=rng.integers(max(max_steps - 6, 0), max_steps, batch).astype(np.int32))


@pytest.mark.parametrize("size", [5, 8, 10])
def test_steps_match_jax_under_its_own_draws(size):
    batch, steps, max_steps = 96, 12, 9
    env_j = jax_sailing.SailingEnv(size=size, max_episode_steps=max_steps)
    env_t = torch_sailing.SailingEnv(size=size, max_episode_steps=max_steps)
    params_j, params_t = env_j.default_params(), env_t.default_params("cpu")
    np.testing.assert_array_equal(params_t.angle_cost.numpy(), np.asarray(params_j["angle_cost"]))
    assert float(params_t.stability) == float(params_j["stability"])
    state_j = jax.tree.map(jnp.asarray, _states(size, batch, size, max_steps))
    state_t = from_numpy(torch_sailing.SailingState, jax.tree.map(np.asarray, state_j),
                         device="cpu")
    step_j = jax.jit(jax.vmap(env_j.step, in_axes=(None, 0, 0, 0)))
    rng = np.random.default_rng(size + 100)
    seen = {"arrived": False, "truncated": False, "clipped": False, "winds": set()}
    for step in range(steps):
        actions = rng.integers(0, 8, batch)
        keys = jax.random.split(jax.random.PRNGKey(1000 * size + step), batch)
        out_j = step_j(params_j, state_j, jnp.asarray(actions, jnp.int32), keys)
        out_t = env_t.step(params_t, state_t, torch.as_tensor(actions), noise=_jax_uniforms(keys))
        for name in ("pos", "wind", "t"):
            np.testing.assert_array_equal(getattr(out_t.state, name).numpy(),
                                          np.asarray(getattr(out_j.state, name)), err_msg=name)
        np.testing.assert_array_equal(out_t.terminated.numpy(), np.asarray(out_j.terminated))
        np.testing.assert_array_equal(out_t.truncated.numpy(), np.asarray(out_j.truncated))
        np.testing.assert_allclose(out_t.reward.numpy(), np.asarray(out_j.reward), atol=ATOL)
        np.testing.assert_allclose(out_t.info["cost"].numpy(), np.asarray(out_j.info["cost"]),
                                   atol=ATOL)
        np.testing.assert_allclose(out_t.obs.numpy(), np.asarray(out_j.obs), atol=ATOL)
        # the observation keys that the graph planners aggregate by
        np.testing.assert_array_equal(
            torch_obs_key(out_t.obs).numpy(),
            np.asarray(jax.vmap(jax_obs_key)(out_j.obs)).astype(np.int64))
        moved = np.abs(out_t.state.pos.numpy() - state_t.pos.numpy()).sum(axis=1)
        seen["clipped"] |= bool((moved == 0).any())
        seen["arrived"] |= bool(out_t.terminated.any())
        seen["truncated"] |= bool(out_t.truncated.any())
        seen["winds"] |= set((out_t.state.wind - state_t.wind).remainder(8).tolist())
        state_j, state_t = out_j.state, out_t.state
    assert seen["arrived"] and seen["truncated"] and seen["clipped"]
    assert seen["winds"] == {0, 1, 7}  # stayed, turned either way
    assert bool((out_t.reward < 0).any()) and float(out_t.reward.min()) >= -1.0


def test_null_key_constant_is_the_jax_draw():
    """The deterministic planners of the JAX package step the env with an
    all-zero key; the port passes the uniform draw that key gives."""
    kw, _ = jax.random.split(jnp.zeros((2,), jnp.uint32))
    assert np.float32(torch_sailing.NULL_KEY_UNIFORM) == np.float32(jax.random.uniform(kw))
    env = torch_sailing.SailingEnv(size=5)
    noise = env.null_noise(3, "cpu")
    assert noise.shape == (3,) and noise.dtype == torch.float32
    state, _ = env.reset(env.default_params("cpu"), torch.Generator().manual_seed(0), 3)
    out = env.transition(env.default_params("cpu"), state, torch.tensor([0, 1, 2]), noise=noise)
    env_j = jax_sailing.SailingEnv(size=5)
    out_j = jax.vmap(env_j.step, in_axes=(None, 0, 0, None))(
        env_j.default_params(), jax_sailing.SailingState(*(jnp.asarray(v.numpy(), jnp.int32)
                                                           for v in state)),
        jnp.arange(3), jnp.zeros((2,), jnp.uint32))
    np.testing.assert_array_equal(out.state.wind.numpy(), np.asarray(out_j.state.wind))
    np.testing.assert_array_equal(out.state.pos.numpy(), np.asarray(out_j.state.pos))


@pytest.mark.parametrize("env_id,size,config", [
    ("sailing-v0", 10, {}), ("sailing-5-v0", 5, {}), ("sailing-10-v0", 10, {}),
    ("sailing-20-v0", 20, {}), ("sailing-v0", 8, {"size": 8}),
    ("sailing-v0", 8, {"size": 8, "max_episode_steps": 7}),
])
def test_make_matches_jax(env_id, size, config):
    config = dict(config, id=env_id)
    handle_j = jax_sailing.make(dict(config))
    handle_t = torch_factory.load_environment(dict(config), device="cpu")
    assert handle_t.functional.size == handle_j.functional.size == size
    assert handle_t.functional.max_episode_steps == handle_j.functional.max_episode_steps \
        == config.get("max_episode_steps", 20 * size)
    assert handle_t.action_space.n == 8
    assert handle_t.functional.observation_space.shape == (10,)
    obs, _ = handle_t.reset(seed=0)
    assert obs.shape == (10,) and obs[:2].tolist() == [0.0, 0.0] and obs[2:].sum() == 1.0
    obs, reward, terminated, truncated, _ = handle_t.step(1)
    assert obs[:2].tolist() == [np.float32(1) / size] * 2 and -1.0 <= reward < 0
    assert not terminated and not truncated
    assert handle_t.mdp.state == (size + 1) * 8 + int(handle_t.state.wind[0])


def test_corpus_env_config_loads():
    handle = torch_factory.load_environment(CONFIGS / "env.json", device="cpu")
    config = json.loads((CONFIGS / "env.json").read_text())
    assert handle.functional.size == config["size"] == 8
    assert handle.functional.max_episode_steps == 160


@pytest.mark.parametrize("size", [5, 8])
def test_mdp_accessor_tables_equal(size):
    mdp_j = jax_sailing.make({"id": "sailing-v0", "size": size}).mdp
    mdp_t = torch_sailing.make({"id": "sailing-v0", "size": size}, device="cpu").mdp
    assert mdp_t.mode == mdp_j.mode == "sparse"
    for name in ("reward", "next", "transition", "terminal"):
        got, want = getattr(mdp_t, name), getattr(mdp_j, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
