"""The KL-bound kernel's plain PyTorch version against the JAX package: the
Pallas kernel in interpret mode and the XLA solver ``kl_upper_bound``.

The tolerance is 1e-5, not 0: XLA's and torch's ``log`` (and XLA's fused
multiply-adds) differ by ulps. A mismatch names the input that caused it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_torch, kl_bound_trips
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS
from rl_agents_tpu.ops.pallas_kl import kl_bound_pallas
from rl_agents_tpu.utils.math import kl_upper_bound

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(n=2000, seed=0):
    """The inputs of tests/ops/test_pallas_kl.py."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 50, size=n).astype(np.float32)
    total = rng.random(n).astype(np.float32) * count
    thr = np.full(n, np.log(10.0), np.float32)
    return total, count, thr


def _assert_close(got, want, total, count, thr):
    got, want = np.ravel(got), np.ravel(want)
    err = np.abs(got - want)
    worst = int(np.argmax(err))
    assert err[worst] <= ATOL, (
        f"input {worst}: sum={total.ravel()[worst]!r} count={count.ravel()[worst]!r} "
        f"threshold={np.broadcast_to(thr, total.shape).ravel()[worst]!r}: "
        f"port {got[worst]!r} vs JAX {want[worst]!r}")


@pytest.mark.parametrize("iters", [24, NEWTON_MAX_ITERATIONS])
@pytest.mark.parametrize("lower", [False, True])
def test_plain_version_matches_pallas_interpret(lower, iters):
    total, count, thr = _inputs()
    want = kl_bound_pallas(total, count, thr, lower=lower, iters=iters, interpret=True)
    got = kl_bound(total, count, thr, lower=lower, iters=iters, device="cpu")
    _assert_close(got.numpy(), want, total, count, thr)


@pytest.mark.parametrize("lower", [False, True])
def test_plain_version_matches_kl_upper_bound(lower):
    total, count, thr = _inputs()
    want = jax.vmap(lambda s, n, t: kl_upper_bound(s, n, t, eps=1e-2, lower=lower))(
        jnp.asarray(total), jnp.asarray(count), jnp.asarray(thr))
    got = kl_bound(total, count, thr, lower=lower, iters=NEWTON_MAX_ITERATIONS, device="cpu")
    _assert_close(got.numpy(), want, total, count, thr)


def test_golden_constant():
    """Reference golden value: kl_upper_bound(0.5, 1, log 10) ~= 0.9975."""
    out = kl_bound(0.5, 1.0, float(np.log(10.0)), device="cpu")
    assert out.shape == () and abs(float(out) - 0.9975) < 1e-3
    np.testing.assert_allclose(float(out), float(kl_upper_bound(0.5, 1.0, np.log(10.0))),
                               atol=ATOL)


def test_edge_cases_match_pallas():
    # zero counts -> vacuous bounds; mu on a boundary -> degenerate interval
    total = np.array([0.0, 0.0, 5.0, 0.0, 3.0], np.float32)
    count = np.array([0.0, 3.0, 5.0, 4.0, 0.0], np.float32)
    thr = np.full(5, 2.0, np.float32)
    for lower in (False, True):
        want = kl_bound_pallas(total, count, thr, lower=lower, interpret=True)
        got = kl_bound(total, count, thr, lower=lower, device="cpu").numpy()
        _assert_close(got, want, total, count, thr)
        assert got[0] == (0.0 if lower else 1.0) and got[4] == (0.0 if lower else 1.0)
    up = kl_bound(total, count, thr, device="cpu").numpy()
    lo = kl_bound(total, count, thr, lower=True, device="cpu").numpy()
    assert up[2] == 1.0 and lo[3] == 0.0
    assert 0.0 < up[1] < 1.0 and np.all(lo <= up + 1e-6)


@pytest.mark.parametrize("shape", [(7, 13), (1001,), (3, 1, 5)])
def test_shapes_and_broadcasting_match_pallas(shape):
    rng = np.random.default_rng(1)
    count = rng.integers(1, 9, size=shape).astype(np.float32)
    total = (rng.random(shape) * count).astype(np.float32)
    thr = np.float32(1.0)
    want = kl_bound_pallas(total, count, thr, interpret=True)
    got = kl_bound(total, count, thr, device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    _assert_close(got.numpy(), want, total, count, thr)


def test_trips_count_the_work_of_each_element():
    total, count, thr = (torch.as_tensor(v) for v in _inputs(500, seed=2))
    trips = kl_bound_trips(total, count, thr, iters=NEWTON_MAX_ITERATIONS)
    assert trips.dtype == torch.int64 and trips.min() >= 1
    assert trips.max() < NEWTON_MAX_ITERATIONS  # every element froze
    capped = kl_bound_trips(total, count, thr, iters=2)
    assert torch.equal(capped, trips.clamp(max=2))
    # a solve cut at an element's own trip count already has its final value
    k = int(trips.max())
    assert torch.equal(kl_bound_torch(total, count, thr, iters=k),
                       kl_bound_torch(total, count, thr, iters=NEWTON_MAX_ITERATIONS))
