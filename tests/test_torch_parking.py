"""The parking surrogate of the PyTorch port against the JAX package: 40-step
rollouts from JAX's replayed reset draws (its bicycle kinematics' ``atan``,
``tan``, ``sin`` and ``cos`` held within 1e-6), the handle's success flag,
and CEM planning at ``ParkingEnv/cem.json``'s sizes under JAX's draws."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.envs import parking as torch_parking
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.utils.noise import threefry_uniform
from rl_agents_tpu.envs import parking as jax_parking
from test_torch_cem import _plan_both
from test_torch_small_envs import ROWS, STEPS, raw, rollout

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"


def reset_draws(keys):
    """The reset's goal x and row draw (rl_agents_tpu/envs/parking.py:69-72)."""
    out = []
    for key in keys:
        kg, kh = jax.random.split(key)
        out.append([threefry_uniform(raw(kg), (), -20.0, 20.0),
                    threefry_uniform(raw(kh), (), 0.0, 1.0)])
    return np.array(out, np.float32)


def test_reset_draws_replay_jax():
    env_j = jax_parking.make({})
    env_t = torch_parking.make({}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    states_j = [env_j.functional.reset(env_j.params, k)[0] for k in keys]
    state_t, obs_t = env_t.functional.reset(env_t.params, None, 16, noise=reset_draws(keys))
    np.testing.assert_array_equal(state_t.goal.numpy(), np.stack([s.goal for s in states_j]))
    assert len(np.unique(state_t.goal[:, 1].numpy())) == 2  # both rows


def test_rollouts_match_under_jax_reset_draws():
    env_j, env_t = jax_parking.make({}), torch_parking.make({}, device="cpu")
    actions = np.random.default_rng(6).uniform(-1.2, 1.2, (STEPS, ROWS, 2)).astype(np.float32)
    state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, actions,
                    reset_noise=reset_draws, exact=False)
    assert float(state.speed.abs().max()) > 1.0


def test_handle_reports_success():
    env_t = torch_parking.make({"duration": 7}, device="cpu")
    assert env_t.functional.max_episode_steps == 7
    env_t.reset(seed=0)
    goal = env_t.state.goal.clone()
    # a car already parked on the goal, facing it, succeeds on its first step
    env_t.state = env_t.state._replace(x=goal[:, 0], y=goal[:, 1], heading=goal[:, 2])
    obs, reward, terminated, truncated, info = env_t.step(np.zeros(2, np.float32))
    assert terminated and bool(info["is_success"]) and reward > -0.12 and obs.shape == (12,)


def test_cem_plans_match_jax():
    config = json.loads((CONFIGS / "ParkingEnv" / "cem.json").read_text())
    plan = dict(horizon=config["horizon"], iterations=config["iterations"],
                candidates=config["candidates"], top_candidates=config["top_candidates"],
                gamma=config["gamma"], action_size=2, discrete=False)
    handle_j = jax_parking.make({})
    handle_t = torch_parking.make({}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    states = [handle_j.functional.reset(handle_j.params, k)[0] for k in keys]
    states = jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]), *states)
    _plan_both(handle_j.functional, handle_j.params, states, handle_t.functional,
               handle_t.params, torch_parking.ParkingState, plan, seeds=[0, 1])


def test_corpus_agents_act():
    env = load_environment(CONFIGS / "ParkingEnv" / "env.json", device="cpu")
    obs, _ = env.reset(seed=0)
    for name in ("cem.json", "RandomUniformAgent.json"):
        agent = load_agent(CONFIGS / "ParkingEnv" / name, env, device="cpu")
        action = np.asarray(agent.act(obs))
        assert action.shape == (2,) and np.isfinite(action).all()  # the env clips it
        assert np.isfinite(env.fork().step(action)[1])


def test_make_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_environment({"id": "parking-v0"})
