"""The draw of the JAX package's all-zero PRNG key, which its deterministic
planners (OPD, GBOP-D, DROP) step a stochastic env with: for a stochastic
finite MDP ``jax.random.categorical`` then takes ``argmax(log p + g)`` with
``g = jax.random.gumbel(zero key, (K,))``, one fixed draw per number of
outcomes K. The port rebuilds it on the host
(``utils/noise.py::threefry_gumbel``, threefry-2x32 in numpy) and
``FiniteMDPEnv.null_noise`` hands it to the planners."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_opd import OPD_BOUNDS, OPD_EXACT, _chain_noise

from rl_agents_torch.agents.tree_search import deterministic as td
from rl_agents_torch.convert import from_numpy, tree_to_numpy
from rl_agents_torch.envs import finite_mdp as tm
from rl_agents_torch.utils.noise import NULL_KEY, threefry_gumbel
from rl_agents_tpu.agents.tree_search import deterministic as jd
from rl_agents_tpu.envs import finite_mdp as jm

torch.set_num_threads(1)

B = 8


@pytest.mark.parametrize("key", [(0, 0), (1, 2), (12345, 678)])
def test_host_draw_is_the_jax_gumbel_draw(key):
    """The bits are JAX's (a shorter draw is a prefix of a longer one); the
    values agree within float32 rounding of XLA's ``log`` (2 ulps), the
    first outcomes exactly, and every argmax is the same."""
    for size in (1, 2, 3, 5, 16, 100):
        want = np.asarray(jax.random.gumbel(jnp.asarray(key, jnp.uint32), (size,), jnp.float32))
        got = threefry_gumbel(key, size)
        assert got.dtype == np.float32 and got.shape == (size,)
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=5e-7)
        np.testing.assert_array_equal(got, threefry_gumbel(key, 200)[:size])
        assert np.argmax(got) == np.argmax(want)
    np.testing.assert_array_equal(threefry_gumbel(NULL_KEY, 3),
                                  np.asarray(jax.random.gumbel(jnp.zeros(2, jnp.uint32), (3,))))


def test_null_noise_of_a_stochastic_mdp_is_the_zero_key_draw():
    env = tm.FiniteMDPEnv(6, 2, mode="stochastic")
    noise = env.null_noise(4, "cpu")
    assert noise.shape == (4, 6)
    want = np.asarray(jax.random.gumbel(jnp.zeros(2, jnp.uint32), (6,), jnp.float32))
    for row in noise.numpy():
        np.testing.assert_allclose(row, want, atol=5e-7)
    assert tm.FiniteMDPEnv(6, 2).null_noise(4, "cpu") is None


@pytest.mark.parametrize("mode", ["sparse", "stochastic"])
def test_opd_on_a_stochastic_mdp_matches_jax_under_the_null_key(monkeypatch, mode):
    """OPD on a stochastic garnet (three outcomes) and on its dense
    ``stochastic``-mode twin, against ``jax.vmap(opd_plan)``: equal trees.
    With zero noise, the most likely next state, the trees differ."""
    env_j, params_j = jm.garnet(jax.random.PRNGKey(4), 10, 3, branching=3)
    arrays = jax.tree.map(np.asarray, params_j)
    if mode == "stochastic":  # the same MDP as dense [S, A, S] probabilities
        dense = np.zeros((10, 3, 10), np.float32)
        for s in range(10):
            for a in range(3):
                for k in range(3):
                    dense[s, a, arrays.next[s, a, k]] += arrays.transition[s, a, k]
        arrays = arrays._replace(transition=dense, next=np.zeros((), np.int32))
        env_j = jm.FiniteMDPEnv(10, 3, mode="stochastic")
        params_j = jax.tree.map(jnp.asarray, arrays)
    s = np.random.default_rng(0).integers(0, 10, B).astype(np.int32)
    states_j = jm.MDPState(s=s, t=np.zeros(B, np.int32), done=np.zeros(B, bool))
    plan = dict(num_actions=3, expansions=8, gamma=0.8, plan_capacity=8)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    _, _, tree_j = jax.vmap(lambda st, k: jd.opd_plan(env_j, params_j, st, k, **plan))(
        jax.tree.map(jnp.asarray, states_j), keys)

    env_t = tm.FiniteMDPEnv(10, 3, mode=mode)
    params_t = from_numpy(tm.MDPParams, arrays, device="cpu")
    states_t = from_numpy(tm.MDPState, states_j, device="cpu")
    noise = _chain_noise(keys, plan["plan_capacity"], 3)

    def plan_t():
        return tree_to_numpy(td.opd_plan(env_t, params_t, states_t, None, noise=noise,
                                         device="cpu", **plan)[2])

    got = plan_t()
    for field in OPD_EXACT:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                      err_msg=field)
    for field in OPD_BOUNDS:
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(tree_j, field)),
                                   atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(got.states.s, np.asarray(tree_j.states.s))

    monkeypatch.setattr(tm.FiniteMDPEnv, "null_noise",
                        lambda self, batch, device: torch.zeros((batch, self.num_states)))
    assert not np.array_equal(plan_t().states.s, np.asarray(tree_j.states.s))
