"""CartPole and finite-MDP transitions: the PyTorch port against the JAX
package on the same states, made with numpy."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs" / "FiniteMDPEnv"
TWO_ARM = {"mode": "deterministic", "transition": [[0, 1], [0, 1]],
           "reward": [[0.0, 1.0], [0.0, 1.0]], "terminal": [0, 0], "max_episode_steps": 100}
LOOP = {"mode": "deterministic", "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
        "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
        "terminal": [0, 0, 0, 1], "max_episode_steps": 7}


def _cartpole_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    state = jax_cartpole.CartPoleState(
        x=rng.uniform(-2.6, 2.6, n).astype(np.float32),
        x_dot=rng.uniform(-3, 3, n).astype(np.float32),
        theta=rng.uniform(-0.25, 0.25, n).astype(np.float32),
        theta_dot=rng.uniform(-3, 3, n).astype(np.float32),
        t=rng.integers(0, 205, n).astype(np.int32),
        done=rng.random(n) < 0.2)
    return state


def test_cartpole_step_matches_jax():
    n = 256
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=200)
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=200)
    params_j = env_j.default_params()
    params_t = from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu")
    state = _cartpole_batch(n)
    state_t = from_numpy(torch_cartpole.CartPoleState, state, device="cpu")
    step_j = jax.jit(jax.vmap(env_j.step, in_axes=(None, 0, 0, None)))
    for action in (0, 1):
        out_j = step_j(params_j, jax.tree.map(jnp.asarray, state),
                       jnp.full(n, action, jnp.int32), jax.random.PRNGKey(0))
        out_t = env_t.step(params_t, state_t, torch.full((n,), action))
        for name in ("x", "x_dot", "theta", "theta_dot"):
            # sin/cos/FMA rounding differs by ulps between XLA and torch
            np.testing.assert_allclose(getattr(out_t.state, name).numpy(),
                                       np.asarray(getattr(out_j.state, name)), atol=1e-6)
        np.testing.assert_array_equal(out_t.state.t.numpy(), np.asarray(out_j.state.t))
        np.testing.assert_array_equal(out_t.state.done.numpy(), np.asarray(out_j.state.done))
        np.testing.assert_array_equal(out_t.reward.numpy(), np.asarray(out_j.reward))
        np.testing.assert_array_equal(out_t.terminated.numpy(), np.asarray(out_j.terminated))
        np.testing.assert_array_equal(out_t.truncated.numpy(), np.asarray(out_j.truncated))
        np.testing.assert_allclose(out_t.obs.numpy(), np.asarray(out_j.obs), atol=1e-6)
    # the gymnasium rule: reward 1 on the terminating step, 0 once done
    assert out_t.terminated[~state_t.done].any()
    np.testing.assert_array_equal(out_t.reward.numpy(), np.where(state.done, 0.0, 1.0))


def test_cartpole_reset_is_batch_first():
    env = torch_cartpole.CartPoleEnv()
    params = env.default_params("cpu")
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(params, gen, batch=5)
    assert obs.shape == (5, 4) and obs.dtype == torch.float32
    assert state.t.dtype == torch.int64 and state.done.dtype == torch.bool
    assert obs.abs().max() <= 0.05
    again, _ = env.reset(params, torch.Generator().manual_seed(3), batch=5)
    assert torch.equal(again.x, state.x)


def _mdp_configs():
    with open(CONFIGS / "env_loop.json") as f:
        env_loop = json.load(f)
    return {"env_loop": env_loop, "two_arm": TWO_ARM, "loop_terminal": LOOP}


@pytest.mark.parametrize("name", ["env_loop", "two_arm", "loop_terminal"])
def test_finite_mdp_deterministic_matches_jax(name):
    config = _mdp_configs()[name]
    env_j, params_j = jax_mdp.params_from_config(config)
    env_t, params_t = torch_mdp.params_from_config(config, device="cpu")
    S, A = env_j.num_states, env_j.num_actions
    s, a, done = np.meshgrid(np.arange(S), np.arange(A), [False, True], indexing="ij")
    s, a, done = s.ravel(), a.ravel(), done.ravel()
    t = np.random.default_rng(0).integers(0, env_j.max_episode_steps + 2, s.size)
    state = jax_mdp.MDPState(s=s.astype(np.int32), t=t.astype(np.int32), done=done)
    out_j = jax.vmap(env_j.step, in_axes=(None, 0, 0, None))(
        params_j, jax.tree.map(jnp.asarray, state), jnp.asarray(a, jnp.int32),
        jax.random.PRNGKey(0))
    out_t = env_t.step(params_t, from_numpy(torch_mdp.MDPState, state, device="cpu"),
                       torch.as_tensor(a))
    for got, want in [(out_t.state.s, out_j.state.s), (out_t.state.t, out_j.state.t),
                      (out_t.state.done, out_j.state.done), (out_t.obs, out_j.obs),
                      (out_t.reward, out_j.reward), (out_t.terminated, out_j.terminated),
                      (out_t.truncated, out_j.truncated)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["stochastic", "sparse"])
def test_finite_mdp_stochastic_modes_follow_their_distribution(mode):
    if mode == "stochastic":
        probs = np.array([[[0.3, 0.7], [1.0, 0.0]], [[0.0, 1.0], [0.6, 0.4]]])
        config = {"mode": mode, "transition": probs.tolist()}
        expected = probs
    else:
        probs = np.array([[[0.2, 0.5, 0.3], [1.0, 0.0, 0.0]],
                          [[0.0, 0.25, 0.75], [0.6, 0.0, 0.4]]])
        nxt = np.array([[[1, 0, 1], [0, 1, 0]], [[1, 1, 0], [0, 0, 1]]])
        config = {"mode": mode, "transition": probs.tolist(), "next": nxt.tolist()}
        expected = np.zeros((2, 2, 2))
        for k in range(3):
            np.add.at(expected, (*np.indices((2, 2)), nxt[..., k]), probs[..., k])
    config["reward"] = np.zeros((2, 2)).tolist()
    env, params = torch_mdp.params_from_config(config, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = 20000
    for s in range(2):
        for a in range(2):
            state = torch_mdp.MDPState(s=torch.full((n,), s), t=torch.zeros(n, dtype=torch.int64),
                                       done=torch.zeros(n, dtype=torch.bool))
            out = env.step(params, state, torch.full((n,), a), gen)
            freq = torch.bincount(out.state.s, minlength=2).numpy() / n
            np.testing.assert_allclose(freq, expected[s, a], atol=0.02)


@pytest.mark.parametrize("relpath", ["env_bandit.json", "haystack/env.json", "env_loop.json"])
def test_params_from_config_matches_jax(relpath):
    with open(CONFIGS / relpath) as f:
        config = json.load(f)
    env_j, params_j = jax_mdp.params_from_config(config)
    env_t, params_t = torch_mdp.params_from_config(config, device="cpu")
    assert (env_t.num_states, env_t.num_actions, env_t.mode, env_t.max_episode_steps) == \
        (env_j.num_states, env_j.num_actions, env_j.mode, env_j.max_episode_steps)
    for got, want in zip(tree_to_numpy(params_t), params_j):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_convert_round_trip():
    state = _cartpole_batch(9, seed=1)
    tensors = from_numpy(torch_cartpole.CartPoleState, state, device="cpu")
    assert tensors.x.dtype == torch.float32 and tensors.t.dtype == torch.int64
    assert tensors.done.dtype == torch.bool
    back = tree_to_numpy(tensors)
    for got, want in zip(back, state):
        np.testing.assert_array_equal(got, want)
    assert back.t.dtype == np.int32


def test_env_handle_carries_a_jax_state_and_forks():
    handle_j = jax_cartpole.make({})
    handle_j.reset(seed=4)
    handle_t = torch_cartpole.make({}, device="cpu")
    handle_t.state = from_numpy(torch_cartpole.CartPoleState,
                                {k: np.asarray(v)[None] for k, v in handle_j.state._asdict().items()},
                                device="cpu")
    fork = handle_t.fork()
    for action in (1, 0, 1):
        obs_j, r_j, term_j, trunc_j, _ = handle_j.step(action)
        obs_t, r_t, term_t, trunc_t, _ = handle_t.step(action)
        np.testing.assert_allclose(obs_t, np.asarray(obs_j), atol=1e-6)
        assert (r_t, term_t, trunc_t) == (r_j, term_j, trunc_j)
    assert fork.state.t.item() == 0  # the fork keeps the state it was made from
    assert handle_t.state.t.item() == 3


def test_garnet_draws_a_seeded_sparse_mdp():
    """The port's garnet has the structure of the JAX package's (shapes, mode,
    rows that are distributions, the share of zeroed rewards) but, drawn from
    a ``torch.Generator``, is another MDP for the same seed."""
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 64, 4, branching=3)
    env_t, params_t = torch_mdp.garnet(torch.Generator().manual_seed(0), 64, 4, branching=3)
    assert (env_t.mode, env_t.num_states, env_t.num_actions) == \
        (env_j.mode, env_j.num_states, env_j.num_actions) == ("sparse", 64, 4)
    for name in torch_mdp.MDPParams._fields:
        got, want = getattr(params_t, name), np.asarray(getattr(params_j, name))
        assert tuple(got.shape) == want.shape, name
        assert got.dtype == (torch.bool if want.dtype == bool else
                             torch.float32 if want.dtype.kind == "f" else torch.int64), name
    np.testing.assert_allclose(params_t.transition.sum(-1).numpy(), 1.0, atol=1e-6)
    assert (params_t.transition > 0).all()
    assert int(params_t.next.min()) >= 0 and int(params_t.next.max()) < 64
    assert len(np.unique(params_t.next.numpy())) > 32
    reward = params_t.reward.numpy()
    assert ((reward == 0) | ((reward > 0) & (reward < 0.5))).all()
    assert abs((reward == 0).mean() - (np.asarray(params_j.reward) == 0).mean()) < 0.15
    again = torch_mdp.garnet(torch.Generator().manual_seed(0), 64, 4, branching=3)[1]
    other = torch_mdp.garnet(torch.Generator().manual_seed(1), 64, 4, branching=3)[1]
    assert all(torch.equal(a, b) for a, b in zip(params_t, again))
    assert not torch.equal(params_t.next, other.next)


def test_garnet_env_from_the_corpus_config_and_its_mdp_view():
    config = json.loads((CONFIGS / "env_garnet.json").read_text())
    env = torch_mdp.make(config, device="cpu")
    same = torch_mdp.make(config, device="cpu")
    assert env.functional.mode == "sparse" and env.functional.max_episode_steps == 20
    assert torch.equal(env.params.next, same.params.next)
    mdp = env.mdp
    assert mdp.mode == "sparse"
    assert mdp.transition.shape == mdp.next.shape == (16, 4, 2) and mdp.reward.shape == (16, 4)
    assert mdp.terminal.shape == (16,) and not mdp.terminal.any()
    for s, a in ((0, 0), (5, 3)):
        assert mdp.next_state(s, a, torch.Generator().manual_seed(2)) in mdp.next[s, a]
    obs, _ = env.reset(seed=0)
    obs, reward, terminated, truncated, _ = env.step(1)
    assert int(obs) in mdp.next[0, 1] and reward == float(mdp.reward[0, 1])
    loop = torch_mdp.make({}, device="cpu").mdp
    assert loop.mode == "deterministic" and loop.next_state(1, 1) == 3


@pytest.mark.parametrize("mode", ["stochastic", "sparse"])
def test_finite_mdp_stochastic_step_matches_jax_under_its_own_draws(mode):
    """The next state is ``argmax(log(max(p, 1e-30)) + g)`` as
    ``jax.random.categorical`` computes it: with JAX's Gumbel draws rebuilt
    from the step keys and injected as ``noise``, the next states are equal."""
    n = 512
    if mode == "sparse":
        env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(2), 16, 4, branching=3)
        outcomes = 3
    else:
        probs = np.random.default_rng(0).dirichlet(np.ones(5), (5, 3))
        probs[0, 0] = [0.0, 1.0, 0.0, 0.0, 0.0]
        env_j, params_j = jax_mdp.params_from_config(
            {"mode": mode, "transition": probs.tolist(), "reward": np.zeros((5, 3)).tolist()})
        outcomes = 5
    env_t = torch_mdp.FiniteMDPEnv(env_j.num_states, env_j.num_actions, mode=mode)
    params_t = from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(1)
    state = jax_mdp.MDPState(s=rng.integers(0, env_j.num_states, n).astype(np.int32),
                             t=np.zeros(n, np.int32), done=rng.random(n) < 0.1)
    actions = rng.integers(0, env_j.num_actions, n)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    out_j = jax.vmap(env_j.step, in_axes=(None, 0, 0, 0))(
        params_j, jax.tree.map(jnp.asarray, state), jnp.asarray(actions, jnp.int32), keys)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (outcomes,), jnp.float32))(keys))
    out_t = env_t.step(params_t, from_numpy(torch_mdp.MDPState, state, device="cpu"),
                       torch.as_tensor(actions), noise=noise)
    np.testing.assert_array_equal(out_t.state.s.numpy(), np.asarray(out_j.state.s))
    np.testing.assert_array_equal(out_t.reward.numpy(), np.asarray(out_j.reward))
    assert len(np.unique(out_t.state.s.numpy())) > 3
    with pytest.raises(ValueError, match="generator or injected noise"):
        env_t.step(params_t, from_numpy(torch_mdp.MDPState, state, device="cpu"),
                   torch.as_tensor(actions))


def test_transition_defaults_to_step_and_null_noise_is_per_env():
    env = torch_cartpole.CartPoleEnv()
    params = env.default_params("cpu")
    state, _ = env.reset(params, torch.Generator().manual_seed(0), batch=3)
    action = torch.tensor([0, 1, 0])
    stepped, moved = env.step(params, state, action), env.transition(params, state, action)
    assert all(torch.equal(a, b) for a, b in zip(stepped.state, moved.state))
    assert torch.equal(stepped.reward, moved.reward)
    assert env.null_noise(3, "cpu") is None
    assert torch_mdp.FiniteMDPEnv(4, 2).null_noise(3, "cpu") is None
    # a stochastic finite MDP under the deterministic planners: the most likely next state
    env_t, params_t = torch_mdp.params_from_config(
        {"mode": "stochastic", "transition": [[[0.3, 0.7], [0.9, 0.1]]] * 2,
         "reward": [[0, 0]] * 2}, device="cpu")
    state = torch_mdp.MDPState(s=torch.zeros(2, dtype=torch.int64),
                               t=torch.zeros(2, dtype=torch.int64),
                               done=torch.zeros(2, dtype=torch.bool))
    out = env_t.transition(params_t, state, torch.tensor([0, 1]), noise=env_t.null_noise(2, "cpu"))
    assert out.state.s.tolist() == [1, 0]
