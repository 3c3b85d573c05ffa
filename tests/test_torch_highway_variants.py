"""The intersection and two-way surrogates of the PyTorch port against the JAX
package, and the config makers on the corpus env configs of the six highway
folders (``HighwayEnv``, ``MergeEnv``, ``ExitEnv``, ``RoundaboutEnv``,
``IntersectionEnv``, ``TwoWayEnv``).

Rollouts start from JAX's reset states and run under the same action
sequences; states, rewards and observations are bit-equal (two-way floats
within 1e-6 relative: see its test). As in the JAX
package, ``IntersectionEnv.transition`` (the open-loop planners' step) is the
inherited highway dynamics, and its ``step`` the crossing dynamics."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.convert import highway_state_from_numpy
from rl_agents_torch.envs import highway as th
from rl_agents_tpu import factory as jax_factory
from rl_agents_tpu.envs import highway as jh

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
FOLDERS = ("HighwayEnv", "MergeEnv", "ExitEnv", "RoundaboutEnv", "IntersectionEnv", "TwoWayEnv")
ENV_CONFIGS = sorted(str(p.relative_to(CONFIGS)) for folder in FOLDERS
                     for p in (CONFIGS / folder).glob("*.json")
                     if "id" in json.loads(p.read_text()))
HIGHWAY_IDS = ("highway", "intersection", "highway-v0", "exit-v0", "merge-v0", "intersection-v0",
               "intersection-multi-agent-v0", "roundabout-v0", "two-way-v0")
B = 8
SEVEN = ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"]
ROLLOUTS = {
    "intersection": ({}, "make_intersection"),
    "intersection_two_egos": ({"controlled_vehicles": 2}, "make_intersection"),
    "intersection_grid7": ({"observation": {"type": "OccupancyGrid", "features": SEVEN}},
                           "make_intersection"),
    "intersection_kinematics7": ({"observation": {"type": "Kinematics", "features": SEVEN}},
                                 "make_intersection"),
    "two_way": ({}, "make_twoway"),
    "two_way_ttc5": ({"observation": {"type": "TimeToCollision", "horizon": 5}}, "make_twoway"),
    "two_way_kinematics7": ({"observation": {"type": "Kinematics", "features": SEVEN}},
                            "make_twoway"),
}


def _rollout(config, maker, dt, steps=20, transition=False, rtol=0.0):
    handle_j = getattr(jh, maker)(dict(config))
    handle_t = getattr(th, maker)(dict(config), device="cpu")
    env_j, env_t = handle_j.functional, handle_t.functional
    params_j = handle_j.params._replace(dt=jnp.float32(dt))
    params_t = handle_t.params._replace(dt=torch.tensor(dt, dtype=torch.float32))
    states_j, _ = jax.vmap(env_j.reset, in_axes=(None, 0))(
        params_j, jax.random.split(jax.random.PRNGKey(2), B))
    states_t = highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")
    # the start state observed by a program of its own: XLA folds the
    # intersection ego's constant start x / 100 exactly inside ``reset``
    obs_j = jax.jit(jax.vmap(env_j.observe, in_axes=(None, 0)))(params_j, states_j)
    pairs = [(obs_j, env_t.observe(params_t, states_t))]
    space = env_j.action_space
    n = space.n if hasattr(space, "n") else space.spaces[0].n
    shape = (steps, B) if hasattr(space, "n") else (steps, B, len(space.spaces))
    acts = np.random.default_rng(1).integers(0, n, shape)
    fn_j = env_j.transition if transition else env_j.step
    fn_t = env_t.transition if transition else env_t.step
    step_j = jax.jit(jax.vmap(fn_j, in_axes=(None, 0, 0, None)))
    for t in range(steps):
        out_j = step_j(params_j, states_j, jnp.asarray(acts[t]), jnp.zeros(2, jnp.uint32))
        out_t = fn_t(params_t, states_t, torch.tensor(acts[t]))
        for name in out_j.state._fields + ("reward", "terminated", "truncated"):
            got = getattr(out_t.state, name) if name in out_j.state._fields \
                else getattr(out_t, name)
            want = np.asarray(getattr(out_j.state, name) if name in out_j.state._fields
                              else getattr(out_j, name))
            if rtol and want.dtype.kind == "f":
                np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol,
                                           err_msg=f"{name} at step {t}")
            else:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} at step {t}")
        if not transition:
            pairs.append((out_j.obs, out_t.obs))
        states_j, states_t = out_j.state, out_t.state
    for obs_j, obs_t in pairs:
        obs_j = obs_j if isinstance(obs_j, tuple) else (obs_j,)
        obs_t = obs_t if isinstance(obs_t, tuple) else (obs_t,)
        for a, b in zip(obs_j, obs_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=rtol)
    return states_t


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
@pytest.mark.parametrize("dt", [1.0, 0.7])
def test_variant_rollouts_are_bit_equal_to_jax(name, dt):
    config, maker = ROLLOUTS[name]
    # JAX's own two-way step rounds the IDM of some trees by an ulp
    # differently with the batch size (its vector and scalar loops fuse
    # differently): two-way floats are held to 1e-6 relative
    last = _rollout(config, maker, dt, rtol=1e-6 if name.startswith("two_way") else 0.0)
    if name.startswith("intersection"):
        assert bool(last.crashed.any()) or bool((last.x[:, 0] > 25).any())


def test_intersection_transition_is_the_inherited_highway_dynamics():
    """OPD and MCTS step the intersection through ``transition``, the JAX
    package's inherited ``HighwayEnv.transition`` on one lane."""
    _rollout({}, "make_intersection", 1.0, steps=10, transition=True)


def test_two_way_oncoming_stream_keeps_its_speed():
    handle = th.make_twoway({}, device="cpu")
    env, params = handle.functional, handle.params
    state, _ = env.reset(params, torch.Generator().manual_seed(0), 16)
    out = env.transition(params, state, torch.full((16,), 1))
    oncoming = slice(env.vehicles - env.oncoming, env.vehicles)
    assert torch.equal(out.state.speed[:, oncoming], state.speed[:, oncoming])
    assert (out.state.x[:, oncoming] < state.x[:, oncoming]).all()


def test_every_highway_id_is_registered():
    assert set(HIGHWAY_IDS) <= set(torch_factory.ENV_REGISTRY)
    for env_id in HIGHWAY_IDS:
        assert torch_factory.ENV_REGISTRY[env_id].split(":")[1] == \
            jax_factory.ENV_REGISTRY[env_id].split(":")[1]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_factory.load_environment({"id": env_id})


def _shapes(space):
    if hasattr(space, "spaces"):
        return tuple(_shapes(s) for s in space.spaces)
    return getattr(space, "n", None), tuple(space.shape)


@pytest.mark.parametrize("path", ENV_CONFIGS)
def test_makers_build_the_jax_env_from_each_corpus_config(path):
    """Each corpus env config of the six folders gives the same env class,
    static structure, params and first observation in both packages."""
    handle_j = jax_factory.load_environment(str(CONFIGS / path))
    handle_t = torch_factory.load_environment(CONFIGS / path, device="cpu")
    env_j, env_t = handle_j.functional, handle_t.functional
    assert type(env_t).__name__ == type(env_j).__name__
    for attr in ("vehicles", "lanes", "max_episode_steps", "controlled_vehicles", "action_type",
                 "obs_type", "obs_features", "obs_vehicles", "ttc_horizon", "grid_shape",
                 "grid_step", "lidar_cells", "lidar_range", "steering_range",
                 "acceleration_range", "oncoming"):
        assert getattr(env_t, attr, None) == getattr(env_j, attr, None), attr
    assert env_t.spec.id == env_j.spec.id
    assert _shapes(env_t.observation_space) == _shapes(env_j.observation_space)
    assert _shapes(env_t.action_space) == _shapes(env_j.action_space)
    for name in handle_j.params._fields:
        np.testing.assert_array_equal(getattr(handle_t.params, name).numpy(),
                                      np.asarray(getattr(handle_j.params, name)), err_msg=name)
    states_j = jax.tree.map(np.asarray, handle_j.state)
    obs_t = env_t.observe(handle_t.params,
                          highway_state_from_numpy(states_j, device="cpu", batched=False))
    obs_j = handle_j.obs if isinstance(handle_j.obs, tuple) else (handle_j.obs,)
    obs_t = obs_t if isinstance(obs_t, tuple) else (obs_t,)
    for a, b in zip(obs_j, obs_t):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), atol=1e-6)
