"""``rl_agents_torch/ops/hashing.py`` against ``rl_agents_tpu/ops/hashing.py``:
the keys are integers and must be identical, and so must the table contents
after the same sequence of inserts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.ops import hashing as th
from rl_agents_tpu.ops import hashing as jh

torch.set_num_threads(1)


def _observations(n=10_000, width=4, seed=0):
    """Random observations, among them negatives, exact zeros, values that sit
    on a rounding tie at precision 1e-4 and values past the int32 range."""
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(n, width)) * 3).astype(np.float32)
    ties = (rng.integers(-2000, 2000, size=(n // 10, width)) + 0.5) * 1e-4
    obs[: n // 10] = ties.astype(np.float32)
    obs[n // 10: n // 10 + 50] = 0.0
    obs[n // 10 + 50: n // 10 + 60] = rng.choice(np.array([3e5, -3e5, 1e9, -1e9], np.float32),
                                                 size=(10, width))
    return obs


@pytest.mark.parametrize("width,precision", [(4, 1e-4), (1, 1e-4), (7, 1e-2)])
def test_obs_key_matches(width, precision):
    """Against ``obs_key`` as the JAX planners run it, under ``jit``: XLA
    multiplies by the float32 reciprocal of the constant precision, where
    eager JAX divides (on values near a rounding tie the two differ)."""
    obs = _observations(width=width)
    want = np.asarray(jax.jit(jax.vmap(lambda o: jh.obs_key(o, precision)))(jnp.asarray(obs)))
    got = th.obs_key(torch.tensor(obs), precision).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 1 and got.max() < 2**32


def test_obs_key_of_integer_states_and_tuples():
    states = np.arange(64, dtype=np.int32)
    want = np.asarray(jax.vmap(jh.obs_key)(jnp.asarray(states)))
    got = th.obs_key(torch.tensor(states).to(torch.int64)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert len(np.unique(got)) == 64
    a = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    b = np.random.default_rng(2).normal(size=(32, 2, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x, y: jh.obs_key((x, y)))(jnp.asarray(a), jnp.asarray(b)))
    got = th.obs_key((torch.tensor(a), torch.tensor(b))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _assert_tables_equal(table_t, tables_j):
    for b, table_j in enumerate(tables_j):
        np.testing.assert_array_equal(table_t.keys[b].numpy().astype(np.uint32),
                                      np.asarray(table_j.keys))
        np.testing.assert_array_equal(table_t.values[b].numpy(), np.asarray(table_j.values))
        assert int(table_t.count[b]) == int(table_j.count)


@pytest.mark.parametrize("capacity,inserts", [(16, 12), (8, 14)])
def test_table_contents_match_after_the_same_inserts(capacity, inserts):
    """B rows take their own key sequences, with repeats and colliding keys;
    at capacity 8 the rows fill up and later inserts are refused."""
    B = 6
    rng = np.random.default_rng(capacity)
    pool = np.concatenate([rng.integers(1, 2**32, size=8, dtype=np.uint64),
                           np.arange(1, 5, dtype=np.uint64) * capacity + 3])  # same start slot
    keys = rng.choice(pool, size=(inserts, B))
    tables_j = [jh.table_init(capacity) for _ in range(B)]
    table_t = th.table_init(capacity, batch=B, device="cpu")
    for step in range(inserts):
        values, news = [], []
        for b in range(B):
            tables_j[b], value, is_new = jh.table_lookup_or_insert(
                tables_j[b], jnp.uint32(keys[step, b]), jnp.int32(100 + step))
            values.append(int(value))
            news.append(bool(is_new))
        before = [t.clone() for t in table_t]
        new_table, value_t, new_t = th.table_lookup_or_insert(
            table_t, torch.tensor(keys[step].astype(np.int64)),
            torch.full((B,), 100 + step, dtype=torch.int64))
        for old, kept in zip(before, table_t):  # the argument is not written
            assert torch.equal(old, kept)
        table_t = new_table
        assert value_t.tolist() == values and new_t.tolist() == news
        _assert_tables_equal(table_t, tables_j)
    if capacity < inserts:
        assert (table_t.count == capacity).any() and -1 in value_t.tolist() + values
    probe = rng.choice(np.concatenate([pool, np.array([5, 77], np.uint64)]), size=(10, B))
    for row in probe:
        want = [int(jh.table_lookup(tables_j[b], jnp.uint32(row[b]))) for b in range(B)]
        got = th.table_lookup(table_t, torch.tensor(row.astype(np.int64))).tolist()
        assert got == want
