"""The rest of the env base of the PyTorch port against
``rl_agents_tpu/envs/base.py``: the spaces' ``sample`` replaying JAX's
threefry draws, ``StepOut.done``, ``FunctionalEnv.rollout`` and
``policy_rollout`` under each tree's replayed keys (CartPole, whose step
draws nothing, and a stochastic garnet, whose step draws ``gumbel(ks, (2,))``),
the batch helpers and the handle's ``unwrapped``,
``get_available_actions`` and ``render``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl_agents_torch.envs as torch_envs
import rl_agents_tpu.envs as jax_envs
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import base as tb
from rl_agents_torch.envs import cartpole as torch_cartpole
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_tpu.envs import base as jb
from rl_agents_tpu.envs import cartpole as jax_cartpole
from rl_agents_tpu.envs import finite_mdp as jax_mdp

torch.set_num_threads(1)

B, T = 8, 30
ATOL = 1e-6


def _raw(key):
    return tuple(int(x) for x in np.asarray(key))


def test_the_package_exports_the_jax_names():
    assert torch_envs.__all__ == jax_envs.__all__
    for name in torch_envs.__all__:
        assert getattr(torch_envs, name) is getattr(tb, name)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_discrete_and_box_samples_replay_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    for n in (2, 5, 13):
        assert int(tb.Discrete(n).sample(key=_raw(key))) == int(jb.Discrete(n).sample(key))
    box_j = jb.Box(low=np.array([-1.0, 0.0, -np.inf]), high=np.array([1.0, 5.0, np.inf]),
                   shape=(3,))
    box_t = tb.Box(low=box_j.low, high=box_j.high, shape=(3,))
    np.testing.assert_array_equal(box_t.sample(key=_raw(key)).numpy(),
                                  np.asarray(box_j.sample(key)))
    pair_j = jb.TupleSpace((jb.Discrete(5), jb.Discrete(3)))
    pair_t = tb.TupleSpace((tb.Discrete(5), tb.Discrete(3)))
    assert [int(a) for a in pair_t.sample(key=_raw(key))] == \
        [int(a) for a in pair_j.sample(key)]
    assert len(pair_t) == 2 and pair_t.shape == (2,)


def test_samples_from_a_generator_are_seeded_and_in_range():
    draw = lambda space, seed: space.sample(torch.Generator().manual_seed(seed))
    box = tb.Box(low=-2.0, high=3.0, shape=(1000,))
    first, again = draw(box, 1), draw(box, 1)
    assert torch.equal(first, again) and not torch.equal(first, draw(box, 2))
    assert first.min() >= -2.0 and first.max() < 3.0
    actions = torch.stack([draw(tb.Discrete(4), s) for s in range(64)])
    assert set(actions.tolist()) == {0, 1, 2, 3}
    with pytest.raises(ValueError, match="generator or a key"):
        tb.Discrete(4).sample()


def test_step_out_done():
    out = tb.StepOut(None, None, None, torch.tensor([True, False, False]),
                     torch.tensor([False, True, False]), {})
    assert out.done.tolist() == [True, True, False]


def _cartpole_case():
    env_j = jax_cartpole.CartPoleEnv(max_episode_steps=20)
    params_j = env_j.default_params()
    v = np.random.default_rng(1).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
    v[2] *= 3.0
    states = jax_cartpole.CartPoleState(*v, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    env_t = torch_cartpole.CartPoleEnv(max_episode_steps=20)
    return (env_j, params_j, states, None), (
        env_t, from_numpy(torch_cartpole.CartPoleParams, params_j, device="cpu"),
        from_numpy(torch_cartpole.CartPoleState, states, device="cpu"))


def _garnet_case():
    env_j, params_j = jax_mdp.garnet(jax.random.PRNGKey(0), 16, 4, branching=2)
    env_t = torch_mdp.FiniteMDPEnv(16, 4, mode=env_j.mode, max_episode_steps=20)
    env_j = jax_mdp.FiniteMDPEnv(16, 4, mode=env_j.mode, max_episode_steps=20)
    s = np.random.default_rng(2).integers(0, 16, B).astype(np.int32)
    states = jax_mdp.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    draw = lambda k: jax.random.gumbel(k, (2,), jnp.float32)
    return (env_j, params_j, states, draw), (
        env_t, from_numpy(torch_mdp.MDPParams, jax.tree.map(np.asarray, params_j), device="cpu"),
        from_numpy(torch_mdp.MDPState, states, device="cpu"))


CASES = {"cartpole": _cartpole_case, "garnet": _garnet_case}


def _assert_outs_equal(got, want):
    """Stacked outputs: the port's ``[T, B, ...]`` against JAX's vmapped
    ``[B, T, ...]``; integer and boolean fields equal, floats within 1e-6."""
    got_state, want_state = tree_to_numpy(got.state), want.state
    pairs = [(f"state.{name}", getattr(got_state, name), getattr(want_state, name))
             for name in got_state._fields]
    pairs += [(name, getattr(got, name).numpy(), getattr(want, name))
              for name in ("obs", "reward", "terminated", "truncated")]
    for name, g, w in pairs:
        w = np.swapaxes(np.asarray(w), 0, 1)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rollout_matches_jax_under_its_step_keys(name):
    """``FunctionalEnv.rollout``: JAX's scan splits ``key, sub`` at every step
    and steps the env with ``sub``."""
    (env_j, params_j, states_j, draw), (env_t, params_t, states_t) = CASES[name]()
    A = env_t.action_space.n
    actions = np.random.default_rng(4).integers(0, A, (T, B)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    want = jax.vmap(lambda s, a, k: env_j.rollout(params_j, s, a, k))(
        jax.tree.map(jnp.asarray, states_j), jnp.asarray(actions.T), keys)
    noise = None
    if draw is not None:
        def per_tree(key):
            subs = []
            for _ in range(T):
                key, sub = jax.random.split(key)
                subs.append(draw(sub))
            return jnp.stack(subs)
        noise = np.swapaxes(np.asarray(jax.vmap(per_tree)(keys)), 0, 1)
    got = env_t.rollout(params_t, states_t, torch.tensor(actions, dtype=torch.int64),
                        noise=noise)
    _assert_outs_equal(got, want)
    assert got.done.any()  # episodes end (terminated, or truncated at 20 steps) inside T


def _policy_logits(name):
    """One stochastic policy in each package: a Gumbel-argmax over logits of
    the observation (a table over the garnet's 16 states; CartPole leans with
    the pole)."""
    if name == "garnet":
        table = np.random.default_rng(9).normal(size=(16, 4)).astype(np.float32)
        return (lambda obs: jnp.asarray(table)[obs],
                lambda obs: torch.tensor(table)[obs])
    return (lambda obs: jnp.stack([-10.0 * obs[2], 10.0 * obs[2]]),
            lambda obs: torch.stack([-10.0 * obs[:, 2], 10.0 * obs[:, 2]], dim=1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_policy_rollout_matches_jax_under_its_keys(name):
    """``policy_rollout``: JAX splits ``key, ka, ks`` at every step, the
    policy draws with ``ka`` and the env steps with ``ks``; rewards after an
    episode's end are zeroed."""
    (env_j, params_j, states_j, draw), (env_t, params_t, states_t) = CASES[name]()
    A = env_t.action_space.n
    logits_j, logits_t = _policy_logits(name)
    # a module-level-like function: jit takes the policy as a static argument
    policy_j = jax.tree_util.Partial(
        lambda obs, k: jnp.argmax(logits_j(obs) + jax.random.gumbel(k, (A,), jnp.float32)))
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    want = jax.vmap(lambda s, k: jb.policy_rollout(env_j, policy_j, params_j, s, k, T))(
        jax.tree.map(jnp.asarray, states_j), keys)

    def per_tree(key):
        policy_g, env_g = [], []
        for _ in range(T):
            key, ka, ks = jax.random.split(key, 3)
            policy_g.append(jax.random.gumbel(ka, (A,), jnp.float32))
            env_g.append(draw(ks) if draw is not None else jnp.zeros(()))
        return jnp.stack(policy_g), jnp.stack(env_g)

    policy_g, env_g = (np.swapaxes(np.asarray(x), 0, 1) for x in jax.vmap(per_tree)(keys))
    got = tb.policy_rollout(env_t, lambda obs, g: (logits_t(obs) + g).argmax(dim=-1), params_t,
                            states_t, T, policy_noise=torch.tensor(policy_g),
                            env_noise=None if draw is None else env_g)
    _assert_outs_equal(got, want)
    ended = got.done.numpy().any(axis=0)
    assert ended.any()
    # a row's rewards after its first end are zero
    first_end = got.done.numpy().argmax(axis=0)
    for b in np.flatnonzero(ended):
        assert (got.reward[first_end[b] + 1:, b] == 0).all()


def test_vector_helpers_are_the_batch_first_functions():
    env = torch_cartpole.CartPoleEnv()
    params = env.default_params("cpu")
    states, obs = tb.vector_reset(env)(params, torch.Generator().manual_seed(0), 5)
    out = tb.vector_step(env)(params, states, torch.zeros(5, dtype=torch.int64))
    assert obs.shape == (5, 4) and out.obs.shape == (5, 4) and out.reward.shape == (5,)


def test_handle_unwrapped_actions_and_render():
    handle = torch_cartpole.make({}, device="cpu")
    assert handle.unwrapped is handle
    assert handle.get_available_actions() == [0, 1]
    assert handle.render() is None
    from rl_agents_torch.envs import highway as th
    from rl_agents_tpu.envs import highway as jh

    for config in ({"vehicles_count": 5}, {"id": "intersection-multi-agent-v0"}):
        assert th.make(dict(config), device="cpu").get_available_actions() == \
            jh.make(dict(config)).get_available_actions()
