"""The small envs of the PyTorch port against the JAX package: dynamics (both
action spaces), GridEnv, LineEnv, MountainCar and the pendulum; and MDP-GapE
planning on ``DummyEnv/gridenv_stoch.json``.

Each env is rolled 40 steps over 8 rows, the port's batched step against
JAX's jitted step row by row, every step's draw replayed on the host from
JAX's key (``utils/noise.py::threefry_uniform`` / ``threefry_randint``).
Rollouts without a transcendental are bit-equal; MountainCar's ``cos`` and the
pendulum's ``sin`` are held within 1e-6."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch as torch_gape_batch
from rl_agents_torch.convert import tree_to_numpy
from rl_agents_torch.envs import classic as torch_classic
from rl_agents_torch.envs import dynamics as torch_dynamics
from rl_agents_torch.envs import gridenv as torch_grid
from rl_agents_torch.factory import load_environment
from rl_agents_torch.utils.noise import threefry_randint, threefry_uniform
from rl_agents_tpu.agents.tree_search.mdp_gape import mdp_gape_plan as jax_gape_plan
from rl_agents_tpu.envs import classic as jax_classic
from rl_agents_tpu.envs import dynamics as jax_dynamics
from rl_agents_tpu.envs import gridenv as jax_grid

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
ROWS, STEPS = 8, 40


def raw(key):
    """A JAX key as the two uint32 the host threefry takes."""
    return tuple(int(v) for v in np.asarray(key))


def step_keys(seed=3, rows=ROWS, steps=STEPS):
    """The key of each row's reset and of its step t: ``[rows]``, ``[steps][rows]``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), rows)
    return keys, [[jax.random.fold_in(k, t) for k in keys] for t in range(steps)]


def uniform_draws(keys):
    return np.array([threefry_uniform(raw(k), (), 0.0, 1.0) for k in keys], np.float32)


def rollout(env_j, params_j, env_t, params_t, actions, step_noise=None, reset_noise=None,
            exact=True, atol=1e-6, seed=3):
    """Roll both envs over ``actions [steps, rows, ...]`` and compare every
    observation, reward and terminal flag; returns the port's final state.
    ``step_noise(keys)`` and ``reset_noise(keys)`` rebuild the port's
    injected draws from the rows' JAX keys."""
    reset_keys, keys = step_keys(seed, actions.shape[1], actions.shape[0])
    jstep, jreset = jax.jit(env_j.step), jax.jit(env_j.reset)
    states_j = [jreset(params_j, k)[0] for k in reset_keys]
    kwargs = {} if reset_noise is None else {"noise": reset_noise(reset_keys)}
    state_t, _ = env_t.reset(params_t, None, actions.shape[1], **kwargs)

    def same(got, want, what):
        if isinstance(got, dict):
            for k in got:
                same(got[k], np.stack([w[k] for w in want]), f"{what}.{k}")
            return
        got, want = got.numpy(), np.asarray(want)
        if exact or got.dtype == bool:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)

    for t, (row_actions, row_keys) in enumerate(zip(actions, keys)):
        outs = [jstep(params_j, s, jnp.asarray(a), k)
                for s, a, k in zip(states_j, row_actions, row_keys)]
        noise = None if step_noise is None else step_noise(row_keys)
        out_t = env_t.step(params_t, state_t, torch.as_tensor(row_actions), None, noise)
        states_j, state_t = [o.state for o in outs], out_t.state
        want_obs = [jax.tree.map(np.asarray, o.obs) for o in outs]
        same(out_t.obs, want_obs if isinstance(out_t.obs, dict) else np.stack(want_obs),
             f"obs at step {t}")
        same(out_t.reward, np.stack([np.asarray(o.reward) for o in outs]), f"reward at step {t}")
        same(out_t.terminated, np.stack([np.asarray(o.terminated) for o in outs]),
             f"terminated at step {t}")
        same(out_t.truncated, np.stack([np.asarray(o.truncated) for o in outs]),
             f"truncated at step {t}")
    return state_t


def discrete_actions(n, seed=0, rows=ROWS, steps=STEPS):
    return np.random.default_rng(seed).integers(0, n, (steps, rows))


@pytest.mark.parametrize("continuous", [False, True])
def test_dynamics_rollouts_are_bit_equal(continuous):
    config = {"continuous": continuous, "dt": 0.1}
    env_j, env_t = jax_dynamics.make(config), torch_dynamics.make(config, device="cpu")
    actions = np.random.default_rng(1).uniform(-1.5, 1.5, (STEPS, ROWS, 1)).astype(np.float32) \
        if continuous else discrete_actions(2)
    rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, actions)


@pytest.mark.parametrize("diagonals", [False, True])
def test_stochastic_grid_rollouts_are_bit_equal_under_jax_draws(diagonals):
    config = {"stochasticity": 0.3, "use_diagonals": diagonals}
    env_j, env_t = jax_grid.make_grid(config), torch_grid.make_grid(config, device="cpu")
    state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params,
                    discrete_actions(8 if diagonals else 4), step_noise=uniform_draws)
    assert state.x.abs().sum() > 0


def test_line_rollouts_are_bit_equal_under_jax_draws():
    env_j, env_t = jax_grid.make_line({}), torch_grid.make_line({}, device="cpu")
    state = rollout(env_j.functional, env_j.params, env_t.functional, env_t.params,
                    discrete_actions(2, steps=12),
                    step_noise=lambda keys: np.array([threefry_randint(raw(k), 2) for k in keys]))
    assert state.done.any()


def test_mountaincar_rollouts_match_under_jax_reset_draws():
    env_j = jax_classic.make_mountaincar({})
    env_t = torch_classic.make_mountaincar({}, device="cpu")
    rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, discrete_actions(3),
            reset_noise=lambda keys: np.array(
                [threefry_uniform(raw(k), (), -0.6, -0.4) for k in keys], np.float32),
            exact=False)


def test_pendulum_rollouts_match_under_jax_reset_draws():
    env_j, env_t = jax_classic.make_pendulum({}), torch_classic.make_pendulum({}, device="cpu")

    def reset_noise(keys):
        out = []
        for k in keys:
            k1, k2 = jax.random.split(k)
            out.append([threefry_uniform(raw(k1), (), -np.pi, np.pi),
                        threefry_uniform(raw(k2), (), -1.0, 1.0)])
        return np.array(out, np.float32)

    rollout(env_j.functional, env_j.params, env_t.functional, env_t.params, discrete_actions(5),
            reset_noise=reset_noise, exact=False)


def test_null_noise_is_the_draw_of_jax_all_zero_key():
    zero = jnp.zeros((2,), jnp.uint32)
    grid = torch_grid.GridEnv(stochasticity=0.3)
    assert grid.null_noise(3, "cpu").tolist() == [float(jax.random.uniform(zero))] * 3
    line = torch_grid.LineEnv()
    assert line.null_noise(2, "cpu").tolist() == [int(jax.random.randint(zero, (), 0, 2))] * 2


def test_makes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for env_id in ("gridenv", "lineenv", "dynamics", "mountaincar", "pendulum"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_environment({"id": env_id})


# ---------------------------------------------------------------------------
# MDP-GapE on the stochastic grid, the dense KL form's path on this env
# ---------------------------------------------------------------------------

GAPE_TREES = 8
EXACT_FIELDS = ("d_parent", "d_depth", "d_count", "d_children", "d_done", "c_parent",
                "c_depth", "c_count", "c_child_keys", "c_children", "c_n_children")
BOUND_FIELDS = ("d_cum_reward", "d_mu_ucb", "d_mu_lcb", "d_value_upper", "d_value_lower",
                "c_value_upper", "c_value_lower")


def _gape_draws(keys, episodes, horizon, num_actions):
    """Each tree's tie-breaking Gumbel draws ``[E + 1, H, B, A]`` and the
    grid's uniform drop draws ``[E + 1, H, B]``, from the keys that
    rl_agents_tpu/.../mdp_gape.py splits (one chain an episode, three keys a
    step: the descent's ``ka`` and the env's ``ks``)."""
    gumbel, drops = [], []
    for key in keys:
        g_rows, d_rows = [], []
        for _ in range(episodes + 1):
            key, chain = jax.random.split(key)
            g_row, d_row = [], []
            for _ in range(horizon):
                chain, ka, ks = jax.random.split(chain, 3)
                g_row.append(np.asarray(jax.random.gumbel(ka, (num_actions,), jnp.float32)))
                d_row.append(threefry_uniform(raw(ks), (), 0.0, 1.0))
            g_rows.append(g_row)
            d_rows.append(d_row)
        gumbel.append(g_rows)
        drops.append(d_rows)
    return (np.transpose(np.array(gumbel, np.float32), (1, 2, 0, 3)),
            np.transpose(np.array(drops, np.float32), (1, 2, 0)))


def test_mdp_gape_on_the_stochastic_grid_matches_jax_draws():
    """``DummyEnv/agents/mdp-gape.json``'s planner on ``gridenv_stoch.json``
    (cut to 10 episodes x horizon 4): the paired ``kl_bounds_pair_`` solves
    its bounds (plain version on the CPU), the grid drops actions from the
    replayed draws."""
    config = json.loads((CONFIGS / "DummyEnv" / "gridenv_stoch.json").read_text())
    env_j, env_t = jax_grid.make_grid(config), torch_grid.make_grid(config, device="cpu")
    plan = dict(num_actions=4, episodes=10, horizon=4, gamma=0.7, accuracy=0.0, confidence=1.0,
                transition_threshold_coeff=0.1, width=2)
    keys = jax.random.split(jax.random.PRNGKey(7), GAPE_TREES)
    start = np.random.default_rng(0).integers(-3, 3, (GAPE_TREES, 2)).astype(np.float32)
    states_j = jax_grid.GridState(jnp.asarray(start), jnp.zeros(GAPE_TREES, jnp.int32))
    best_j, used_j, tree_j = jax.vmap(
        lambda s, k: jax_gape_plan(env_j.functional, env_j.params, s, k, **plan))(states_j, keys)
    noise, env_noise = _gape_draws(keys, plan["episodes"], plan["horizon"], plan["num_actions"])
    assert 0 < (env_noise < 0.3).mean() < 1  # some actions are dropped
    states_t = torch_grid.GridState(torch.tensor(start), torch.zeros(GAPE_TREES, dtype=torch.int64))
    best_t, used_t, tree_t = torch_gape_batch(env_t.functional, env_t.params, states_t,
                                              noise=noise, env_noise=env_noise, device="cpu",
                                              **plan)
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(used_t.numpy(), np.asarray(used_j))
    tree_np = tree_to_numpy(tree_t)
    sizes = {"d": tree_j.d_parent.shape[1], "c": tree_j.c_parent.shape[1]}
    for field in EXACT_FIELDS + BOUND_FIELDS:
        got, want = getattr(tree_np, field), np.asarray(getattr(tree_j, field))
        if got.ndim >= 2:
            got = got[:, :sizes[field[0]]]
        if field in EXACT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=field)
    assert np.ptp(np.asarray(tree_j.d_mu_ucb)) > 0.05  # the KL solve did real work
