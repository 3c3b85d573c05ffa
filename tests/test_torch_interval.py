"""The interval predictor of the PyTorch port (``robust/interval.py``) against
the JAX package's, on numpy-seeded systems of 2 and 4 states.

``lpv_step`` over a batch equals JAX's jitted step row by row bit for bit
(XLA's fused multiply-adds are written out). JAX's ``lpv_trajectory`` scans
the step under another compilation, whose roundings differ: the port's
trajectory is held within 1e-6 of it, relative to the interval's size, and
equal to JAX's step iterated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.robust import interval as torch_interval
from rl_agents_tpu.robust import interval as jax_interval

torch.set_num_threads(1)

ROWS, STEPS = 16, 40


def _system(p, seed):
    rng = np.random.default_rng(seed)
    return dict(a0=rng.normal(size=(p, p)) * 0.5, da=rng.normal(size=(2, p, p)) * 0.2,
                b=rng.normal(size=(p, 1)), d=rng.normal(size=(p, 1)),
                k=rng.normal(size=(1, p)) * 0.1, omega=[[-0.1], [0.2]])


def _jax_lpv(system, lo, hi):
    lpv = jax_interval.make_lpv(system["a0"], system["da"], lo, system["b"], system["d"],
                                system["omega"], system["k"])
    return lpv._replace(x_lo=jnp.asarray(lo, jnp.float32), x_hi=jnp.asarray(hi, jnp.float32))


@pytest.mark.parametrize("p", [2, 4])
def test_lpv_step_is_bit_equal_to_jax(p):
    system = _system(p, p)
    rng = np.random.default_rng(10 + p)
    lo = rng.normal(size=(ROWS, p)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(ROWS, p))).astype(np.float32)
    u = rng.uniform(-1, 1, (ROWS, 1)).astype(np.float32)
    want = [jax_interval.lpv_step(_jax_lpv(system, lo[i], hi[i]), jnp.asarray(u[i]), 0.05)
            for i in range(ROWS)]
    lpv = torch_interval.make_lpv(system["a0"], system["da"], lo, system["b"], system["d"],
                                  system["omega"], system["k"], device="cpu")
    got = torch_interval.lpv_step(lpv._replace(x_hi=torch.tensor(hi)), torch.tensor(u), 0.05)
    np.testing.assert_array_equal(got.x_lo.numpy(), np.stack([w.x_lo for w in want]))
    np.testing.assert_array_equal(got.x_hi.numpy(), np.stack([w.x_hi for w in want]))


@pytest.mark.parametrize("p", [2, 4])
def test_lpv_trajectory_matches_jax(p):
    system = _system(p, 20 + p)
    rng = np.random.default_rng(30 + p)
    x0 = rng.normal(size=(ROWS, p)).astype(np.float32)
    controls = rng.uniform(-1, 1, (STEPS, ROWS, 1)).astype(np.float32)
    lpv = torch_interval.make_lpv(system["a0"], system["da"], x0, system["b"], system["d"],
                                  system["omega"], system["k"], device="cpu")
    lo_t, hi_t = torch_interval.lpv_trajectory(lpv, torch.tensor(controls), 0.05)
    for i in range(ROWS):
        lpv_j = _jax_lpv(system, x0[i], x0[i])
        lo_j, hi_j = jax_interval.lpv_trajectory(lpv_j, jnp.asarray(controls[:, i]), 0.05)
        scale = max(1.0, float(np.abs(np.asarray(hi_j)).max()), float(np.abs(np.asarray(lo_j)).max()))
        np.testing.assert_allclose(lo_t[:, i].numpy(), np.asarray(lo_j), rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(hi_t[:, i].numpy(), np.asarray(hi_j), rtol=0, atol=1e-6 * scale)
        for t in range(STEPS):  # JAX's step iterated: equal
            lpv_j = jax_interval.lpv_step(lpv_j, jnp.asarray(controls[t, i]), 0.05)
        np.testing.assert_array_equal(lo_t[-1, i].numpy(), np.asarray(lpv_j.x_lo))
        np.testing.assert_array_equal(hi_t[-1, i].numpy(), np.asarray(lpv_j.x_hi))


def test_interval_contains_every_admissible_trajectory():
    """tests/agents/test_robust.py's containment check, on the port."""
    a0 = np.array([[0.0, 1.0], [0.0, -0.5]])
    da = np.array([[[0.0, 0.0], [0.0, -0.5]]])
    x0 = np.array([1.0, 0.0])
    lpv = torch_interval.make_lpv(a0, da, x0, device="cpu")
    lo, hi = torch_interval.lpv_trajectory(lpv, torch.zeros((20, 1)), 0.05)
    for theta in (0.0, 0.3, 1.0):
        a = a0 + theta * da[0]
        x = x0.copy()
        for t in range(20):
            x = x + 0.05 * (a @ x)
            assert np.all(lo[t, 0].numpy() <= x + 1e-5) and np.all(x <= hi[t, 0].numpy() + 1e-5)


def test_a_polytope_of_another_state_size_fails_as_in_jax():
    """ObstacleEnv's 4-state polytope on the 2-state plant: JAX raises a
    TypeError adding A0 to B K (rl_agents_tpu/robust/interval.py:65)."""
    lpv_j = jax_interval.make_lpv(np.zeros((4, 4)), np.zeros((1, 4, 4)), np.zeros(2),
                                  b=np.ones((2, 1)), k=np.zeros((1, 2)))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_interval.lpv_step(lpv_j._replace(x_lo=jnp.zeros(2), x_hi=jnp.zeros(2)),
                              jnp.zeros(1), 0.1)
    lpv_t = torch_interval.make_lpv(np.zeros((4, 4)), np.zeros((1, 4, 4)), np.zeros(4),
                                    b=np.ones((2, 1)), k=np.zeros((1, 2)), device="cpu")
    with pytest.raises(TypeError, match="incompatible shapes"):
        torch_interval.lpv_step(lpv_t._replace(x_lo=torch.zeros(1, 2), x_hi=torch.zeros(1, 2)),
                                torch.zeros(1), 0.1)
