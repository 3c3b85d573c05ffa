"""The highway surrogate of the PyTorch port against the JAX package.

``rl_agents_torch/envs/highway.py`` is held to ``rl_agents_tpu/envs/highway.py``
on the same states, taken from JAX's ``reset`` through
``convert.highway_state_from_numpy``: 40-step rollouts of ``step`` under fixed
action sequences give bit-equal states, rewards and 5-feature observations on
the default env and on the ``merge-v0``, ``exit-v0`` and ``roundabout-v0``
configs. XLA fuses some multiply-adds of the dynamics into FMAs and turns
divisions by constants into multiplications by their reciprocals; the port
does the same, and a multiply and an add miss by an ulp (the last test of the
rollouts). The heading columns of 7-feature rows and the lidar go through
``atan2``/``cos``/``sin``, which differ by ulps: they are held within 1e-6.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.convert import highway_state_from_numpy
from rl_agents_torch.envs import highway as th
from rl_agents_tpu.envs import highway as jh

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
B = 8
STEPS = 40
HIGHWAY = {"vehicles_count": 15, "lanes_count": 4, "duration": 40}
ROLLOUTS = {
    "highway": (HIGHWAY, "make"),
    "merge-v0": ({"id": "merge-v0"}, "make"),
    "exit-v0": ({"id": "exit-v0"}, "make"),
    "roundabout-v0": ({"id": "roundabout-v0"}, "make_roundabout"),
}
_STEPS_J = {}


def _jax_step(env_j):
    """One jitted ``vmap`` of the JAX env's step per env (shared by the tests)."""
    if env_j not in _STEPS_J:
        _STEPS_J[env_j] = jax.jit(jax.vmap(env_j.step, in_axes=(None, 0, 0, None)))
    return _STEPS_J[env_j]


def _pair(config, maker="make", dt=None):
    handle_j = getattr(jh, maker)(dict(config))
    handle_t = getattr(th, maker)(dict(config), device="cpu")
    params_j, params_t = handle_j.params, handle_t.params
    if dt is not None:
        params_j = params_j._replace(dt=jnp.float32(dt))
        params_t = params_t._replace(dt=torch.tensor(dt, dtype=torch.float32))
    return (handle_j.functional, params_j), (handle_t.functional, params_t)


def _actions(env_j, rng, steps=STEPS):
    space = env_j.action_space
    if hasattr(space, "n"):
        return rng.integers(0, space.n, (steps, B))
    if hasattr(space, "spaces"):
        return rng.integers(0, space.spaces[0].n, (steps, B, len(space.spaces)))
    return rng.uniform(-1.2, 1.2, (steps, B, 2)).astype(np.float32)


def _rollout(config, maker="make", dt=None, seed=0, steps=STEPS):
    """Both envs stepped from JAX's reset states under the same actions, each
    on its own states. Returns per-step pairs ``(jax StepOut, torch StepOut)``
    and the two start observations."""
    (env_j, params_j), (env_t, params_t) = _pair(config, maker, dt)
    states_j, obs_j = jax.vmap(env_j.reset, in_axes=(None, 0))(
        params_j, jax.random.split(jax.random.PRNGKey(seed), B))
    states_t = highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")
    obs_t = env_t.observe(params_t, states_t)
    acts = _actions(env_j, np.random.default_rng(seed), steps)
    step_j = _jax_step(env_j)
    outs = []
    for t in range(steps):
        out_j = step_j(params_j, states_j, jnp.asarray(acts[t]), jnp.zeros(2, jnp.uint32))
        out_t = env_t.step(params_t, states_t, torch.tensor(acts[t]))
        outs.append((out_j, out_t))
        states_j, states_t = out_j.state, out_t.state
    return outs, (obs_j, obs_t)


def _mismatches(outs, obs_atol=0.0, obs_columns=None):
    """Count of differing entries per field over a rollout."""
    counts = {}

    def add(name, a, b, atol=0.0):
        a, b = np.asarray(a), b.detach().cpu().numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        bad = np.abs(a.astype(np.float64) - b.astype(np.float64)) > atol
        counts[name] = counts.get(name, 0) + int(bad.sum())

    for out_j, out_t in outs:
        for name in out_j.state._fields:
            add(name, getattr(out_j.state, name), getattr(out_t.state, name))
        for name in ("reward", "terminated", "truncated"):
            add(name, getattr(out_j, name), getattr(out_t, name))
        obs_j = out_j.obs if isinstance(out_j.obs, tuple) else (out_j.obs,)
        obs_t = out_t.obs if isinstance(out_t.obs, tuple) else (out_t.obs,)
        for a, b in zip(obs_j, obs_t):
            if obs_columns is not None:
                a, b = np.asarray(a)[..., obs_columns], b[..., obs_columns]
            add("obs", a, b, obs_atol)
    return {k: v for k, v in counts.items() if v}


def test_reset_states_convert_and_port_reset_draws_the_same_law():
    (env_j, params_j), (env_t, params_t) = _pair(HIGHWAY)
    states_j, obs_j = jax.vmap(env_j.reset, in_axes=(None, 0))(
        params_j, jax.random.split(jax.random.PRNGKey(1), B))
    states_t = highway_state_from_numpy(jax.tree.map(np.asarray, states_j), device="cpu")
    assert states_t.x.shape == (B, 15) and states_t.speed_level.shape == (B,)
    assert states_t.target_lane.dtype == torch.int64 and states_t.alive.dtype == torch.bool
    np.testing.assert_array_equal(env_t.observe(params_t, states_t).numpy(), np.asarray(obs_j))
    one = highway_state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[0], states_j),
                                   device="cpu", batched=False)
    assert torch.equal(one.x, states_t.x[:1])

    state, obs = env_t.reset(params_t, torch.Generator().manual_seed(0), 64)
    assert obs.shape == (64, 15, 5)
    assert (state.x[:, 0] == 0).all() and (state.lane[:, 0] == 3).all()
    assert (state.speed[:, 0] == 25).all() and (state.speed_level == 1).all()
    gaps = state.x.diff(dim=1)
    assert ((gaps >= 25) & (gaps <= 30)).all()
    assert ((state.speed[:, 1:] >= 20) & (state.speed[:, 1:] <= 25)).all()
    assert set(state.lane[:, 1:].unique().tolist()) == {0.0, 1.0, 2.0, 3.0}
    again, _ = env_t.reset(params_t, torch.Generator().manual_seed(0), 64)
    assert torch.equal(again.x, state.x)


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_is_bit_equal_to_jax(name):
    config, maker = ROLLOUTS[name]
    outs, (obs0_j, obs0_t) = _rollout(config, maker)
    np.testing.assert_array_equal(obs0_t.numpy(), np.asarray(obs0_j))
    assert _mismatches(outs) == {}
    # the rollout exercised the dynamics: lane changes, crashes or speed changes
    first, last = outs[0][1].state, outs[-1][1].state
    assert not torch.equal(first.lane, last.lane) or bool(last.crashed.any())


def test_rollout_at_a_fractional_step_needs_the_fused_multiply_adds(monkeypatch):
    """At dt = 0.7 every fused site rounds: with ``fma`` the rollout is
    bit-equal; with a multiply and an add, speeds, positions and rewards
    differ by an ulp."""
    assert _mismatches(_rollout(HIGHWAY, dt=0.7)[0]) == {}
    monkeypatch.setattr(th, "fma", lambda a, b, c: a * b + c)
    plain = _mismatches(_rollout(HIGHWAY, dt=0.7)[0])
    assert plain.get("speed", 0) > 0 and plain.get("x", 0) > 0 and plain.get("reward", 0) > 0


OBSERVATIONS = {
    # name: (config, maker, columns held exactly, tolerance of the others)
    "kinematics7": ({"observation": {"type": "Kinematics", "features": [
        "presence", "x", "y", "vx", "vy", "cos_h", "sin_h"]}}, "make", [0, 1, 2, 3, 4]),
    "ttc": ({"observation": {"type": "TimeToCollision", "horizon": 10}}, "make", None),
    "occupancy_grid": ({"observation": {"type": "OccupancyGrid"}}, "make", None),
    "lidar": ({"observation": {"type": "LidarObservation"}}, "make", None),
}


@pytest.mark.parametrize("name", sorted(OBSERVATIONS))
def test_observation_types_match_jax(name):
    """5-feature kinematics are bit-equal (the rollouts above); 7-feature rows
    are bit-equal but for the heading columns, which hold within 1e-6; TTC is
    bit-equal; the occupancy grid and the lidar hold within 1e-6. At dt = 0.7,
    where lane changes leave fractional lanes and lateral speeds."""
    config, maker, exact_columns = OBSERVATIONS[name]
    outs, _ = _rollout(config, maker, dt=0.7, steps=15)
    assert _mismatches(outs, obs_atol=1e-6) == {}
    if exact_columns is not None:
        assert _mismatches(outs, obs_columns=exact_columns) == {}
    elif name == "ttc":
        assert _mismatches(outs) == {}
    if name == "kinematics7":
        assert outs[0][1].obs.shape == (B, 15, 7)


@pytest.mark.parametrize("name,config,fields_within", [
    ("multi_agent", json.loads((CONFIGS / "HighwayEnv" / "env_multi_agent.json").read_text()),
     ()),
    ("continuous", json.loads((CONFIGS / "HighwayEnv" / "env_continuous.json").read_text()),
     ("lane", "obs")),
])
def test_multi_ego_and_continuous_actions(name, config, fields_within):
    """N egos take ``[B, N]`` meta-actions and see a tuple of N observations;
    continuous actions ``[B, 2]`` steer the ego through ``sin`` (its lane
    within 1e-6, everything else bit-equal)."""
    outs, _ = _rollout(config, steps=15)
    counts = _mismatches(outs)
    assert set(counts) <= set(fields_within), counts
    for out_j, out_t in outs:
        np.testing.assert_allclose(out_t.state.lane.numpy(), np.asarray(out_j.state.lane),
                                   atol=1e-6)
    if name == "multi_agent":
        _, (env_t, params_t) = _pair(config)
        assert isinstance(outs[0][1].obs, tuple) and len(outs[0][1].obs) == \
            env_t.controlled_vehicles == 3
        assert outs[0][1].state.speed_level.shape == (B, 3)


# ---------------------------------------------------------------------------
# The analytic IDM / MOBIL cases of tests/envs/test_highway_fidelity.py
# ---------------------------------------------------------------------------

def _state(env, x, lane, speed):
    V = env.vehicles
    lane = torch.tensor([lane], dtype=torch.float32)
    return th.HighwayState(
        x=torch.tensor([x], dtype=torch.float32), lane=lane, target_lane=lane.to(torch.int64),
        speed=torch.tensor([speed], dtype=torch.float32),
        speed_level=torch.ones(1, dtype=torch.int64), alive=torch.ones((1, V), dtype=torch.bool),
        crashed=torch.zeros(1, dtype=torch.bool), t=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("x,lane,speed,want", [
    ([0.0, 0.0], [0, 2], [20.0, 20.0], [1.7712, 1.7712]),   # free road
    ([0.0, 30.0], [1, 1], [25.0, 20.0], [-5.0, 1.7712]),    # slower leader: braking limit
    ([0.0, 45.0], [1, 1], [20.0, 20.0], [-1.2288, 1.7712]),  # equal speed at desired gap
])
def test_idm_goldens(x, lane, speed, want):
    env = th.HighwayEnv(vehicles=2, lanes=4)
    acc = env._idm_acceleration(env.default_params("cpu"), _state(env, x, lane, speed),
                                torch.tensor(25.0))
    np.testing.assert_allclose(acc[0].numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("vehicles,lanes,x,lane,speed,want", [
    # stuck behind a slow leader: changes left (ties go left)
    (4, 3, [500.0, 50.0, 75.0, -500.0], [2, 1, 1, 1], [25.0, 25.0, 15.0, 25.0], [2, 0, 1, 1]),
    # a follower 3 m behind in the only free lane: vetoed
    (3, 2, [47.0, 50.0, 75.0], [1, 0, 0], [25.0, 25.0, 15.0], [1, 0, 0]),
    # free road: no gain, no change
    (2, 2, [1000.0, 0.0], [0, 0], [25.0, 25.0], [0, 0]),
    # concurrent movers into the middle lane 2 m apart: the rear one is suppressed
    (5, 3, [1000.0, 50.0, 52.0, 70.0, 72.0], [1, 0, 2, 0, 2], [25.0, 25.0, 25.0, 10.0, 10.0],
     [1, 0, 1, 0, 2]),
    # the same movers 120 m apart: both change
    (5, 3, [1000.0, 50.0, 170.0, 70.0, 190.0], [1, 0, 2, 0, 2], [25.0, 25.0, 25.0, 10.0, 10.0],
     [1, 1, 1, 0, 2]),
])
def test_mobil_goldens(vehicles, lanes, x, lane, speed, want):
    env = th.HighwayEnv(vehicles=vehicles, lanes=lanes)
    state = _state(env, x, lane, speed)
    new_target, _ = env._mobil_target_lanes(env.default_params("cpu"), state, state.target_lane,
                                            torch.tensor(25.0))
    assert new_target[0].tolist() == want


@pytest.mark.parametrize("crossing_x,crash,reward", [(-9.0, True, 0.0), (6.0, False, 0.5)])
def test_intersection_conflict_goldens(crossing_x, crash, reward):
    """Ego at -8 (v = 10) reaches +2 in one step; a crossing vehicle at -9
    (v = 8) reaches -1: both in the +-5 m zone, a crash. From +6 it clears:
    reward 0.5 * v / 10."""
    env = th.IntersectionEnv(vehicles=2)
    out = env.step(env.default_params("cpu"), _state(env, [-8.0, crossing_x], [0, 0],
                                                     [10.0, 8.0]), torch.ones(1))
    assert bool(out.terminated[0]) == crash and bool(out.info["crashed"][0]) == crash
    np.testing.assert_allclose(float(out.reward[0]), reward, rtol=1e-5)
