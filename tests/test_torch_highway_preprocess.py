"""The highway surrogate's host-side views and preprocessors in the PyTorch
port against the JAX package: ``to_finite_mdp``, and ``simplify``,
``change_vehicles`` and the no-op preprocessors through
``EnvHandle.preprocess`` (which applies a preprocessor's state transform and
re-observes, as the JAX handle does); and the ``left_lane_reward`` aliasing
of the config parser."""
import jax
import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.convert import highway_state_from_numpy
from rl_agents_torch.envs import highway as th
from rl_agents_tpu.envs import highway as jh

torch.set_num_threads(1)

HIGHWAY = {"vehicles_count": 15, "lanes_count": 4, "duration": 40}


def test_to_finite_mdp_matches_jax():
    config = {"observation": {"type": "TimeToCollision", "horizon": 10}}
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    for step in range(6):
        state_j = handle_j.state
        handle_t.state = highway_state_from_numpy(jax.tree.map(np.asarray, state_j),
                                                  device="cpu", batched=False)
        view_j, view_t = handle_j.to_finite_mdp(), handle_t.to_finite_mdp()
        for field in ("transition", "reward", "terminal"):
            np.testing.assert_array_equal(getattr(view_t, field), getattr(view_j, field))
        assert view_t.state == view_j.state and view_t.mode == "deterministic"
        handle_j.step(3 if step % 2 else 0)
    assert (view_t.transition == view_t.transition.max()).any()  # some TTC cell is occupied


def _handles(config=HIGHWAY, seed=4):
    handle_j, handle_t = jh.make(dict(config)), th.make(dict(config), device="cpu")
    handle_j.reset(seed=seed)
    handle_t.state = highway_state_from_numpy(jax.tree.map(np.asarray, handle_j.state),
                                              device="cpu", batched=False)
    return handle_j, handle_t


@pytest.mark.parametrize("args", [(), (4,)])
def test_simplify_through_the_handle_preprocess(args):
    """``EnvHandle.preprocess`` applies the state transform of ``simplify``
    and re-observes the smaller state, as the JAX handle does."""
    handle_j, handle_t = _handles()
    new_j, new_t = handle_j.preprocess("simplify", args), handle_t.preprocess("simplify", args)
    keep = args[0] if args else 6
    assert new_t.functional.vehicles == new_j.functional.vehicles == keep
    for name in new_j.state._fields:
        np.testing.assert_array_equal(getattr(new_t.state, name)[0].numpy(),
                                      np.asarray(getattr(new_j.state, name)), err_msg=name)
    np.testing.assert_array_equal(new_t.obs[0].numpy(), np.asarray(new_j.obs))
    assert handle_t.functional.vehicles == 15 and handle_t.state.x.shape == (1, 15)
    obs_t, reward_t, *_ = new_t.step(1)
    obs_j, reward_j, *_ = new_j.step(1)
    np.testing.assert_array_equal(obs_t, obs_j)
    assert reward_t == reward_j


@pytest.mark.parametrize("preset", ["AggressiveVehicle", "DefensiveVehicle", "LinearVehicle",
                                    "IntervalVehicle"])
def test_change_vehicles_through_the_handle_preprocess(preset):
    handle_j, handle_t = _handles()
    spec = f"highway_env.vehicle.behavior.{preset}"
    new_j, new_t = handle_j.preprocess("change_vehicles", spec), \
        handle_t.preprocess("change_vehicles", spec)
    for name in new_j.params._fields:
        np.testing.assert_array_equal(getattr(new_t.params, name).numpy(),
                                      np.asarray(getattr(new_j.params, name)), err_msg=name)
    assert new_t.functional is handle_t.functional
    for _ in range(5):
        obs_t, reward_t, *_ = new_t.step(3)
        obs_j, reward_j, *_ = new_j.step(3)
        np.testing.assert_array_equal(obs_t, obs_j)
        assert reward_t == reward_j


def test_unknown_preprocessors_are_no_ops_as_in_jax():
    """``set_preferred_lane`` (``DiscreteRobustPlannerAgent/lane_change.json``)
    raises ValueError in the env, which the handle takes as a no-op;
    ``set_route_at_intersection`` returns the env itself."""
    _, handle_t = _handles()
    for name, args in (("set_preferred_lane", 0), ("set_route_at_intersection", [1])):
        new = torch_factory.preprocess_env(handle_t, [{"method": name, "args": args}])
        assert new is not handle_t and new.functional is handle_t.functional
        assert torch.equal(new.state.x, handle_t.state.x)
    with pytest.raises(ValueError):
        handle_t.functional.preprocess("set_preferred_lane", 0)


def test_left_lane_reward_aliases_the_right_lane_slot_as_in_jax():
    """The JAX quirk (``highway.py:1083``, ADVICE.md): ``left_lane_reward``
    lands in ``right_lane_reward`` for every env class that reads the key,
    unless ``right_lane_reward`` is set too."""
    for config, want in (({"left_lane_reward": 0.3}, 0.3),
                         ({"left_lane_reward": 0.3, "right_lane_reward": 0.05}, 0.05),
                         ({}, 0.1)):
        for maker in ("make", "make_twoway", "make_intersection"):
            params_j = getattr(jh, maker)(dict(config)).params
            params_t = getattr(th, maker)(dict(config), device="cpu").params
            assert float(params_t.right_lane_reward) == float(params_j.right_lane_reward) \
                == np.float32(want)
