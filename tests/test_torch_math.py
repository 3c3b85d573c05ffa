"""``rl_agents_torch/utils/math.py`` against ``rl_agents_tpu/utils/math.py``
on the same numpy inputs, and against the golden constants of
``tests/agents/test_utils.py`` (copied here).

Elementwise helpers agree within 1e-6 (one float32 rounding of ``%`` or a
division); the KL bounds and the constrained expectation within 1e-5, since
XLA's and torch's ``log`` differ by ulps and their sums run in another
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.utils import math as tm
from rl_agents_tpu.ops.pallas_kl import kl_bound_pallas
from rl_agents_tpu.utils import math as jm

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def test_elementwise_helpers_match():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=200) * 5).astype(np.float32)
    x[:5] = [0.0, 0.005, -0.005, 0.01, -0.01]
    cases = [
        (tm.constrain(_t(x), -1.0, 2.0), jm.constrain(x, -1.0, 2.0)),
        (tm.not_zero(_t(x)), jm.not_zero(x)),
        (tm.not_zero(_t(x), eps=0.5), jm.not_zero(x, eps=0.5)),
        (tm.wrap_to_pi(_t(x)), jm.wrap_to_pi(x)),
        (tm.remap(_t(x), (-1.0, 3.0), (0.0, 10.0)), jm.remap(x, (-1.0, 3.0), (0.0, 10.0))),
        (tm.remap(_t(x), (-1.0, 3.0), (0.0, 10.0), clip=True),
         jm.remap(x, (-1.0, 3.0), (0.0, 10.0), clip=True)),
        (tm.pos(_t(x)), jm.pos(x)),
        (tm.neg(_t(x)), jm.neg(x)),
    ]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6,
                                   err_msg=f"case {i}")


def test_host_helpers_match():
    assert tm.near_split(10, num_bins=3) == jm.near_split(10, num_bins=3) == [4, 3, 3]
    assert tm.near_split(10, size_bins=4) == jm.near_split(10, size_bins=4)
    assert list(tm.zip_with_singletons([1, 2], "a", [3, 4])) == \
        list(jm.zip_with_singletons([1, 2], "a", [3, 4])) == [(1, "a", 3), (2, "a", 4)]


def test_random_dist_is_a_distribution_and_seeded():
    q = tm.random_dist(torch.Generator().manual_seed(3), 7)
    again = tm.random_dist(torch.Generator().manual_seed(3), 7)
    assert q.shape == (7,) and (q > 0).all() and float(q.sum()) == pytest.approx(1.0, abs=1e-6)
    assert torch.equal(q, again)


def test_argmax_helpers_match():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(50, 6)).astype(np.float32)
    mask = rng.random((50, 6)) < 0.5
    mask[0] = False
    want_all = np.stack([np.asarray(jm.all_argmax(row)) for row in x])
    np.testing.assert_array_equal(tm.all_argmax(_t(x)).numpy(), want_all)
    want_masked = np.stack([np.asarray(jm.masked_argmax(row, m)) for row, m in zip(x, mask)])
    got_masked = tm.masked_argmax(_t(x), _t(mask)).numpy()
    np.testing.assert_array_equal(got_masked, want_masked)
    assert got_masked[0] == -1
    # random_argmax draws among the maximisers, each of them in turn
    generator = torch.Generator().manual_seed(0)
    seen = np.zeros_like(want_all)
    for _ in range(60):
        draw = tm.random_argmax(generator, _t(x)).numpy()
        assert want_all[np.arange(50), draw].all()
        seen[np.arange(50), draw] = True
    np.testing.assert_array_equal(seen, want_all)
    key_draw = int(jm.random_argmax(jax.random.PRNGKey(0), x[3]))
    assert want_all[3, key_draw]


def test_kullback_leibler_matches():
    rng = np.random.default_rng(2)
    p = rng.random((40, 5)).astype(np.float32)
    q = rng.random((40, 5)).astype(np.float32)
    p[:10, 0] = 0.0
    q[5:15, 1] = 0.0
    p /= p.sum(-1, keepdims=True)
    q /= q.sum(-1, keepdims=True)
    want = np.stack([np.asarray(jm.kullback_leibler(a, b)) for a, b in zip(p, q)])
    got = tm.kullback_leibler(_t(p), _t(q)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(want).any()
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], atol=ATOL)


def _kl_inputs(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 40, size=n).astype(np.float32)
    total = np.floor(rng.random(n) * (count + 1)).astype(np.float32)
    thr = (rng.random(n) * 8).astype(np.float32)
    return total, count, thr


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("eps", [1e-2, 1e-3])
def test_kl_upper_bound_matches(lower, eps):
    total, count, thr = _kl_inputs()
    want = jax.vmap(lambda s, n, t: jm.kl_upper_bound(s, n, t, eps=eps, lower=lower))(
        jnp.asarray(total), jnp.asarray(count), jnp.asarray(thr))
    got = tm.kl_upper_bound(_t(total), _t(count), _t(thr), eps=eps, lower=lower, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if eps == 1e-2:  # the Pallas wrapper takes its eps only as the default
        pallas = kl_bound_pallas(total, count, thr, lower=lower, iters=jm.NEWTON_MAX_ITERATIONS,
                                 interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
    arena_want = jm.kl_bounds_arena(jnp.asarray(total), jnp.asarray(count), jnp.asarray(thr),
                                    lower=lower)
    arena_got = tm.kl_bounds_arena(_t(total), _t(count), _t(thr), lower=lower, device="cpu")
    np.testing.assert_allclose(arena_got.numpy(), np.asarray(arena_want), atol=ATOL)


def test_kl_upper_bound_golden():
    """tests/agents/test_utils.py:42-62, the reference's golden constants."""
    def ucb(*args, **kw):
        return float(tm.kl_upper_bound(*args, **kw, device="cpu"))

    assert ucb(0.5 * 1, 1, threshold=np.log(10), eps=1e-3) == pytest.approx(0.997, abs=2e-3)
    assert ucb(0.5 * 10, 10, threshold=np.log(20), eps=1e-3) == pytest.approx(0.835, abs=2e-3)
    assert ucb(0.5 * 20, 20, threshold=np.log(40), eps=1e-3) == pytest.approx(0.777, abs=2e-3)
    assert ucb(0.0, 0) == 1.0
    assert ucb(0.0, 0, lower=True) == 0.0
    assert ucb(5.0, 5, threshold=np.log(10)) == pytest.approx(1.0, abs=1e-6)
    rng = np.random.default_rng(2)
    for _ in range(5):
        count, time = np.sort(rng.integers(1, 500, 2))
        mu = rng.random()
        bound = tm.kl_upper_bound(mu * count, count, threshold=np.log(time), eps=1e-3,
                                  device="cpu")
        divergence = tm.bernoulli_kullback_leibler(torch.tensor(mu, dtype=torch.float32), bound)
        assert float(divergence) == pytest.approx(np.log(time) / count, abs=1e-1)


def test_kl_upper_bound_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.kl_upper_bound(0.5, 1.0, 1.0)


def test_newton_iteration_matches():
    targets = np.linspace(0.5, 30.0, 16).astype(np.float32)
    want = [jm.newton_iteration(lambda x, t=t: x * x - t, lambda x: 2 * x, 1e-4, x0=1.0,
                                a=0.0, b=10.0) for t in targets]
    t = _t(targets)
    got = tm.newton_iteration(lambda x: x * x - t, lambda x: 2 * x, 1e-4,
                              x0=torch.ones(16), a=0.0, b=10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy()[:-1] ** 2, targets[:-1], rtol=1e-3)
    # the default start is the middle of a finite interval
    mid_want = jm.newton_iteration(lambda x: x * x - 4.0, lambda x: 2 * x, 1e-4, a=0.0, b=10.0)
    mid_got = tm.newton_iteration(lambda x: x * x - 4.0, lambda x: 2 * x, 1e-4, a=0.0, b=10.0)
    assert float(mid_got) == pytest.approx(float(mid_want), abs=ATOL)


@pytest.mark.parametrize("block", [1, 3, 8])
def test_newton_iteration_blocks_change_trips_not_results(block, monkeypatch):
    """Leaving the loop once no element is active gives, bit for bit, what all
    ``max_iterations`` masked trips give, whatever the block size; the trips
    run are counted and are a whole number of blocks."""
    t = _t(np.linspace(0.5, 30.0, 16).astype(np.float32))
    solve = lambda: tm.newton_iteration(lambda x: x * x - t, lambda x: 2 * x, 1e-4,
                                        x0=torch.ones(16), a=0.0, b=10.0)
    monkeypatch.setattr(tm, "NEWTON_BLOCK", tm.NEWTON_MAX_ITERATIONS)
    want = solve()
    monkeypatch.setattr(tm, "NEWTON_BLOCK", block)
    monkeypatch.setattr(tm.newton_iteration, "calls", 0)
    monkeypatch.setattr(tm.newton_iteration, "trips", 0)
    got = solve()
    assert torch.equal(got, want)
    assert tm.newton_iteration.calls == 1
    assert 0 < tm.newton_iteration.trips < tm.NEWTON_MAX_ITERATIONS
    assert tm.newton_iteration.trips % block == 0


def test_binary_search_matches():
    targets = np.linspace(0.3, 40.0, 12).astype(np.float32)
    want_grow = [jm.binary_search(lambda x, t=t: t - x, 1e-3, a=0.0) for t in targets]
    want_fixed = [jm.binary_search(lambda x, t=t: t - x, 1e-3, a=0.0, b=64.0) for t in targets]
    t = _t(targets)
    got_grow = tm.binary_search(lambda x: t - x, 1e-3, a=torch.zeros(12))
    got_fixed = tm.binary_search(lambda x: t - x, 1e-3, a=torch.zeros(12), b=64.0)
    np.testing.assert_allclose(got_grow.numpy(), np.asarray(want_grow), atol=ATOL)
    np.testing.assert_allclose(got_fixed.numpy(), np.asarray(want_fixed), atol=ATOL)
    np.testing.assert_allclose(got_fixed.numpy(), targets, atol=2e-3)


def _constrained_cases(width, seed):
    """Random problems of one width, among them zero-mass atoms, an all-zero
    q, a constant f and case A (the best atom has no mass)."""
    rng = np.random.default_rng(seed)
    n = 24
    f = rng.random((n, width)).astype(np.float32)
    q = rng.random((n, width)).astype(np.float32)
    c = (rng.random(n) * 0.8 + 0.01).astype(np.float32)
    if width > 1:
        q[:6, 0] = 0.0                      # zero-mass atoms
        f[:3, 0] = 2.0                      # case A: the maximum sits on one of them
        q[6] = 0.0                          # all-zero q
        f[7] = 0.5                          # constant f
        f[8, 1:] = 0.25                     # constant f on the support only
        q[8, 0] = 0.0
    q = q / np.maximum(q.sum(-1, keepdims=True), 1e-30)
    q[6] = 0.0
    return f, q, c


@pytest.mark.parametrize("width", [1, 2, 5])
@pytest.mark.parametrize("eps", [1e-2, 1e-4])
def test_max_expectation_under_constraint_matches(width, eps):
    f, q, c = _constrained_cases(width, seed=width)
    want = np.asarray(jax.vmap(lambda f, q, c: jm.max_expectation_under_constraint(f, q, c, eps))(
        jnp.asarray(f), jnp.asarray(q), jnp.asarray(c)))
    got = tm.max_expectation_under_constraint(_t(f), _t(q), _t(c), eps=eps).numpy()
    assert got.shape == (24, width)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
    if width == 1:
        np.testing.assert_array_equal(got, 1.0)
    # one problem without a batch axis is the same function
    single = tm.max_expectation_under_constraint(_t(f[0]), _t(q[0]), _t(c[0]), eps=eps).numpy()
    np.testing.assert_allclose(single, want[0], atol=ATOL)


def test_max_expectation_under_constraint_golden():
    """tests/agents/test_utils.py:71-108: the optimum dominates q and spends
    the KL budget."""
    q = np.array([0, 0, 1, 1], dtype=np.float32) / 2
    f = np.array([1, 1, 0, 0], dtype=np.float32)
    p = tm.max_expectation_under_constraint(_t(f), _t(q), 0.3, eps=1e-3)
    assert float(q @ f) <= float(p.numpy() @ f)
    assert 0.3 - 1e-1 <= float(tm.kullback_leibler(_t(q), p)) <= 0.3 + 1e-1
    q = np.array([0, 1, 1], dtype=np.float32) / 2
    f = np.array([0, 1, 1], dtype=np.float32)
    p = tm.max_expectation_under_constraint(_t(f), _t(q), 0.1, eps=1e-3)
    assert float(q @ f) <= float(p.numpy() @ f)
    assert float(tm.kullback_leibler(_t(q), p)) <= 0.1 + 1e-1
    rng = np.random.default_rng(3)
    q = rng.random((50, 10)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    f = rng.random((50, 10)).astype(np.float32)
    c = rng.random(50).astype(np.float32)
    p = tm.max_expectation_under_constraint(_t(f), _t(q), _t(c), eps=1e-4).numpy()
    kl = (q * np.log(q / np.maximum(p, 1e-12))).sum(-1)
    assert ((q * f).sum(-1) <= (p * f).sum(-1) + 1e-5).all()
    assert ((c - 1e-1 <= kl) & (kl <= c + 1e-1)).all()
