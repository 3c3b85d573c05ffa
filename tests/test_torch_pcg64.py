"""The PCG64 port against numpy's ``Generator(PCG64)`` and the JAX package.

Raw 64-bit draws, ``integers`` (buffered 32-bit Lemire, the rejection path
included), ``choice`` and ``random()`` are bit-equal to numpy's for several
seeds, one stream per seed on a leading batch axis; after the same calls the
stream's 16-bit digits and its 32-bit buffer equal those of the JAX
package's ``pcg64``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.utils import pcg64 as tp
from rl_agents_tpu.utils import pcg64 as jp

torch.set_num_threads(1)

SEEDS = [0, 1, 3, 42, 2024, 123456789]


def _u64(hi, lo):
    return (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)


def test_init_matches_numpy_state():
    for seed in SEEDS:
        stream, inc = tp.pcg64_init(seed, device="cpu")
        state = np.random.PCG64(seed).state
        assert tp.digits_to_int(stream.digits) == state["state"]["state"]
        assert tp.digits_to_int(inc) == state["state"]["inc"]
        assert not bool(stream.has_buf)


def test_raw_draws_match_numpy_batched():
    stream, inc = tp.pcg64_init(SEEDS, device="cpu")
    assert stream.digits.shape == (len(SEEDS), 8)
    want = np.stack([np.random.PCG64(s).random_raw(64) for s in SEEDS])
    got = []
    for _ in range(64):
        stream, (hi, lo) = tp.pcg64_next64(stream, inc)
        got.append(_u64(hi, lo))
    np.testing.assert_array_equal(np.stack(got, axis=1), want)


def test_integers_choice_and_random_match_numpy():
    """Mixed calls, as a planner makes them: bounded integers of several
    ranges (one draw per two calls through the 32-bit buffer; ranges near
    2^32 reject often), ``choice`` over a list, and doubles that bypass the
    buffer."""
    rng = np.random.default_rng(0)
    gens = [np.random.Generator(np.random.PCG64(s)) for s in SEEDS]
    stream, inc = tp.pcg64_init(SEEDS, device="cpu")
    for step in range(400):
        kind = step % 4
        if kind == 0:
            n = rng.integers(1, 12, len(SEEDS))
            want = [int(g.integers(0, int(k))) for g, k in zip(gens, n)]
            stream, got = tp.pcg64_integers(stream, inc, torch.tensor(n))
        elif kind == 1:
            n = rng.integers(3 * 2 ** 30, 2 ** 32 - 1, len(SEEDS))
            want = [int(g.integers(0, int(k))) for g, k in zip(gens, n)]
            stream, got = tp.pcg64_integers(stream, inc, torch.tensor(n))
        elif kind == 2:
            k = int(rng.integers(1, 8))
            want = [int(g.choice(np.arange(k))) for g in gens]
            stream, got = tp.pcg64_choice(stream, inc, k)
        else:
            want = [g.random() for g in gens]
            stream, got = tp.pcg64_double(stream, inc)
            assert got.dtype == torch.float64
        assert got.tolist() == want, step
    for g, digits, buf, has in zip(gens, stream.digits, stream.buf, stream.has_buf):
        state = g.bit_generator.state
        assert tp.digits_to_int(digits) == state["state"]["state"]
        assert bool(has) == bool(state["has_uint32"])
        if state["has_uint32"]:
            assert int(buf) == state["uinteger"]


def test_masked_lanes_keep_their_stream():
    stream, inc = tp.pcg64_init([5, 6], device="cpu")
    new, value = tp.pcg64_integers(stream, inc, torch.tensor([7, 7]),
                                   mask=torch.tensor([True, False]))
    assert int(value[1]) == 0
    assert torch.equal(new.digits[1], stream.digits[1])
    assert not torch.equal(new.digits[0], stream.digits[0])
    assert int(value[0]) == int(np.random.Generator(np.random.PCG64(5)).integers(0, 7))
    new, _ = tp.pcg64_double(stream, inc, mask=torch.tensor([False, True]))
    assert torch.equal(new.digits[0], stream.digits[0])


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_stream_digits_match_jax(seed):
    stream_t, inc_t = tp.pcg64_init(seed, device="cpu")
    stream_j, inc_j = jp.pcg64_init(seed)
    np.testing.assert_array_equal(inc_t.numpy(), np.asarray(inc_j))
    for n in [2, 3, 5, 1, 100, 2 ** 31 + 5, 9, 4, 2]:
        stream_t, v_t = tp.pcg64_integers(stream_t, inc_t, n)
        stream_j, v_j = jp.pcg64_integers(stream_j, inc_j, jnp.uint32(n))
        assert int(v_t) == int(v_j)
        np.testing.assert_array_equal(stream_t.digits.numpy(), np.asarray(stream_j.digits))
        assert bool(stream_t.has_buf) == bool(stream_j.has_buf)
        assert int(stream_t.buf) == int(stream_j.buf)
    for _ in range(3):
        stream_t, (hi_t, lo_t) = tp.pcg64_next64(stream_t, inc_t)
        stream_j, (hi_j, lo_j) = jp.pcg64_next64(stream_j, inc_j)
        assert (int(hi_t), int(lo_t)) == (int(hi_j), int(lo_j))
    np.testing.assert_array_equal(stream_t.digits.numpy(), np.asarray(stream_j.digits))


def test_parity_stream_wrapper():
    gen = np.random.Generator(np.random.PCG64(5))
    ps = tp.ParityStream(5, device="cpu")
    items = ["a", "b", "c", "d"]
    for _ in range(6):
        assert ps.choice(items) == items[int(gen.integers(0, 4))]
