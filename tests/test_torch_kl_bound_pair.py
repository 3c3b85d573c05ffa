"""The paired KL-bound form ``kl_bounds_pair_`` (both bounds of the arena
entries at given offsets, in place, one launch): its plain version against
the Pallas kernel in interpret mode and JAX's ``kl_upper_bound`` on the
gathered entries, its masks, its count-indexed threshold table, its input
checks, and the two planners' calls of it.

The tolerance against JAX is 1e-5, not 0: XLA's and torch's ``log`` (and
XLA's fused multiply-adds) differ by ulps. Against ``kl_bound_torch``, which
the plain version runs, results are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import graph_based_stochastic as gbop_module
from rl_agents_torch.agents.tree_search import mdp_gape as gape_module
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.ops import kl_bound as kl_module
from rl_agents_torch.ops.kl_bound import kl_bound_torch, kl_bounds_pair_
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS
from rl_agents_tpu.ops.pallas_kl import kl_bound_pallas
from rl_agents_tpu.utils.math import kl_upper_bound as jax_kl_upper_bound

torch.set_num_threads(1)

ATOL = 1e-5
TREES, EPISODES, DEPTHS = 13, 20, 5
NODES = 1 + (EPISODES + 1) * DEPTHS  # an MDP-GapE decision arena
GRAPH = (9, 4, 2)  # a stochastic GBOP row: nodes x actions x next-state slots
SENTINEL_UCB, SENTINEL_LCB = -7.0, 7.0
# tests/test_torch_olop.py
LOOP_CONFIG = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 1000,
}


def _gape_arena(seed):
    """MDP-GapE-like statistics in a ``[TREES, NODES]`` arena (counts
    0..EPISODES + 1, sums of rewards in [0, 1]), a path ``[DEPTHS, TREES]`` of
    distinct nodes per tree, and the threshold table of ``reward_threshold``
    at confidence 0.9, all made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, EPISODES + 2, (TREES, NODES))
    count[:, :6] = np.maximum(count[:, :6], 1)
    total = (rng.random((TREES, NODES)) * count).astype(np.float32)
    total[:, :3] = count[:, :3]  # mu == 1: the upper interval is a point
    total[:, 3:6] = 0.0          # mu == 0: the lower one is
    path = np.argsort(rng.random((TREES, NODES - 6)), axis=1)[:, :DEPTHS].T + 6
    path[0, :4] = [1, 2, 4, 5]   # the point intervals, at depth 1 of trees 0 to 3
    table = gape_module.reward_threshold(torch.arange(EPISODES + 2), DEPTHS, 4, 0.9)
    return (torch.tensor(total), torch.tensor(count), torch.tensor(np.ascontiguousarray(path)),
            table)


def _gbop_arena(seed):
    """Stochastic-GBOP-like statistics in ``[TREES, *GRAPH]`` arenas: sums of
    Sailing's rewards in [-1, 1] (mostly negative), counts 0..11, one visited
    offset per tree, and the scalar threshold 1 log(6)."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 12, (TREES,) + GRAPH)
    total = (rng.uniform(-1.0, 0.2, (TREES,) + GRAPH) * count).astype(np.float32)
    offset = rng.integers(0, int(np.prod(GRAPH)), TREES)
    return (torch.tensor(total), torch.tensor(count), torch.tensor(offset),
            torch.tensor(np.float32(np.log(np.float32(6)))))


ARENAS = {"mdp_gape_path": _gape_arena, "gbop_step": _gbop_arena}


def _bounds(shape):
    return torch.full(shape, SENTINEL_UCB), torch.full(shape, SENTINEL_LCB)


def _gathered(total, count, at, threshold):
    """The entries at the offsets, flattened in ``at``'s order, and the
    threshold of each."""
    per_tree = at.reshape(-1, TREES).t()
    s = total.reshape(TREES, -1).gather(1, per_tree)
    n = count.reshape(TREES, -1).gather(1, per_tree)
    t = threshold[n] if threshold.dim() == 1 else threshold.expand(n.shape)
    return per_tree, s, n, t


@pytest.mark.parametrize("iters", [24, NEWTON_MAX_ITERATIONS])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_pair_matches_pallas_and_kl_upper_bound(arena, iters):
    total, count, at, threshold = ARENAS[arena](seed=0)
    ucb, lcb = kl_bounds_pair_(*_bounds(total.shape), total, count, at, threshold, iters=iters)
    per_tree, s, n, t = _gathered(total, count, at, threshold)
    got = {False: ucb.reshape(TREES, -1).gather(1, per_tree),
           True: lcb.reshape(TREES, -1).gather(1, per_tree)}
    s_np, n_np, t_np = s.numpy(), n.numpy().astype(np.float32), t.numpy()
    for lower, bound in got.items():
        # the plain version is two dense solves: equal to them
        assert torch.equal(bound, kl_bound_torch(s, n.float(), t, lower=lower, iters=iters))
        wants = [np.asarray(kl_bound_pallas(s_np, n_np, t_np, lower=lower, iters=iters,
                                            interpret=True))]
        if iters == NEWTON_MAX_ITERATIONS:  # the XLA solver runs to its own stop
            wants.append(np.asarray(jax.vmap(
                lambda a, b, c: jax_kl_upper_bound(a, b, c, eps=1e-2, lower=lower))(
                    *(jnp.asarray(v.ravel()) for v in (s_np, n_np, t_np)))).reshape(s_np.shape))
        for want in wants:
            err = np.abs(bound.numpy() - want)
            worst = np.unravel_index(int(np.argmax(err)), err.shape)
            assert err[worst] <= ATOL, (
                f"{arena} lower={lower} entry {worst}: sum={s_np[worst]!r} count={n_np[worst]!r} "
                f"threshold={t_np[worst]!r}: port {bound.numpy()[worst]!r} vs JAX {want[worst]!r}")
    if arena == "gbop_step":
        assert (s < 0).sum() > TREES // 2  # negative sums went through the solve
    else:  # the point intervals: mu itself above, 0 below
        assert (got[False][:2, 0] == 1).all() and (got[True][2:4, 0] == 0).all()


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_pair_leaves_masked_trees_and_other_entries_untouched(arena):
    total, count, at, threshold = ARENAS[arena](seed=1)
    noise = torch.Generator().manual_seed(0)
    before = (torch.randn(total.shape, generator=noise), torch.randn(total.shape, generator=noise))
    mask = torch.tensor(np.random.default_rng(2).random(TREES) < 0.5)
    mask[:2] = torch.tensor([True, False])
    ucb, lcb = kl_bounds_pair_(before[0].clone(), before[1].clone(), total, count, at, threshold,
                               mask)
    on = torch.zeros(total.shape, dtype=torch.bool)
    on.view(TREES, -1).scatter_(1, at.reshape(-1, TREES).t(), True)
    written = on & mask.reshape((TREES,) + (1,) * (total.dim() - 1))
    for got, old in zip((ucb, lcb), before):
        assert torch.equal(got[~written], old[~written])  # bit for bit
    want_ucb, want_lcb = kl_bounds_pair_(*_bounds(total.shape), total, count, at, threshold)
    assert torch.equal(ucb[written], want_ucb[written])
    assert torch.equal(lcb[written], want_lcb[written])
    assert (lcb[written] <= ucb[written]).all()


def test_pair_skips_masked_trees_with_bad_entries():
    """A masked-out tree is neither read nor checked, as in the kernel."""
    total, count, at, table = _gape_arena(seed=3)
    count[0] = EPISODES + 7  # outside the table
    at[:, 1] = NODES         # outside the row
    mask = torch.ones(TREES, dtype=torch.bool)
    mask[:2] = False
    ucb, lcb = kl_bounds_pair_(*_bounds(total.shape), total, count, at, table, mask)
    assert (ucb[:2] == SENTINEL_UCB).all() and (lcb[:2] == SENTINEL_LCB).all()
    assert (ucb[2:] != SENTINEL_UCB).sum() == (TREES - 2) * DEPTHS


@pytest.mark.parametrize("confidence", [0.9, 0.5, 1.0])
def test_threshold_table_gives_reward_threshold_exactly(confidence):
    """The per-plan table of MDP-GapE, read at a count, is bit for bit what
    ``reward_threshold`` gives for that count, and the pair solves with it
    what two dense solves at the per-entry threshold give."""
    table = gape_module.reward_threshold(torch.arange(EPISODES + 2), DEPTHS, 4, confidence)
    counts = torch.tensor(np.random.default_rng(4).integers(0, EPISODES + 2, (DEPTHS, 97)))
    assert torch.equal(table[counts],
                       gape_module.reward_threshold(counts, DEPTHS, 4, confidence))
    assert torch.equal(table[1:2], gape_module.reward_threshold(torch.tensor([1]), DEPTHS, 4,
                                                                confidence))
    total, count, at, _ = _gape_arena(seed=5)
    ucb, lcb = kl_bounds_pair_(*_bounds(total.shape), total, count, at, table)
    per_tree, s, n, _ = _gathered(total, count, at, table)
    threshold = gape_module.reward_threshold(n, DEPTHS, 4, confidence)
    for out, lower in ((ucb, False), (lcb, True)):
        assert torch.equal(out.view(TREES, -1).gather(1, per_tree),
                           kl_bound_torch(s, n.float(), threshold, lower=lower,
                                          iters=NEWTON_MAX_ITERATIONS))


def test_pair_returns_its_arenas_and_handles_an_empty_path():
    total, count, at, table = _gape_arena(seed=6)
    ucb, lcb = _bounds(total.shape)
    got = kl_bounds_pair_(ucb, lcb, total, count, at, table)
    assert got[0] is ucb and got[1] is lcb
    empty = torch.zeros((0, TREES), dtype=torch.int64)
    got = kl_bounds_pair_(*_bounds(total.shape), total, count, empty, table)
    assert all(torch.equal(a, b) for a, b in zip(got, _bounds(total.shape)))


META = torch.device("meta")
# case -> (what the error says, how the good inputs ucb, lcb, sum, count, at, thr are spoiled)
BAD_INPUTS = {
    "count as f32": ("count must be torch.int64",
                     lambda u, l, s, c, a, t: (u, l, s, c.float(), a, t)),
    "sum as f64": ("sum must be torch.float32",
                   lambda u, l, s, c, a, t: (u, l, s.double(), c, a, t)),
    "ucb as f16": ("ucb must be torch.float32", lambda u, l, s, c, a, t: (u.half(), l, s, c, a, t)),
    "at as i32": ("at must be torch.int64", lambda u, l, s, c, a, t: (u, l, s, c, a.int(), t)),
    "threshold as f64": ("threshold must be torch.float32",
                         lambda u, l, s, c, a, t: (u, l, s, c, a, t.double())),
    "threshold a float": ("threshold must be a tensor",
                          lambda u, l, s, c, a, t: (u, l, s, c, a, 1.0)),
    "threshold 2-d": ("threshold must be 0-d or a non-empty 1-d table",
                      lambda u, l, s, c, a, t: (u, l, s, c, a, t.reshape(2, -1))),
    "threshold table empty": ("non-empty 1-d table",
                              lambda u, l, s, c, a, t: (u, l, s, c, a, t[:0])),
    "lcb of another shape": (r"one \[B, \.\.\.\] shape",
                             lambda u, l, s, c, a, t: (u, l[:, :-1].contiguous(), s, c, a, t)),
    "count of another shape": (r"one \[B, \.\.\.\] shape",
                               lambda u, l, s, c, a, t: (u, l, s, c[:-1].contiguous(), a, t)),
    "at of another width": (rf"at must be \[{TREES}\] or \[H, {TREES}\]",
                            lambda u, l, s, c, a, t: (u, l, s, c, a[:, :-1].contiguous(), t)),
    "at 3-d": ("at must be", lambda u, l, s, c, a, t: (u, l, s, c, a[None], t)),
    "sum not contiguous": ("sum must be contiguous",
                           lambda u, l, s, c, a, t: (u, l, s.t().contiguous().t(), c, a, t)),
    "count on another device": ("count on meta, expected cpu",
                                lambda u, l, s, c, a, t: (u, l, s, c.to(META), a, t)),
    "all on the meta device": ("unsupported device meta",
                               lambda *args: tuple(v.to(META) for v in args)),
    "lcb is ucb": ("three arenas", lambda u, l, s, c, a, t: (u, u, s, c, a, t)),
    "ucb is sum": ("three arenas", lambda u, l, s, c, a, t: (s, l, s, c, a, t)),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_pair_refuses_bad_inputs(case):
    message, spoil = BAD_INPUTS[case]
    total, count, at, table = _gape_arena(seed=7)
    args = spoil(*_bounds(total.shape), total, count, at, table)
    with pytest.raises((TypeError, ValueError), match=f"kl_bounds_pair_: .*{message}"):
        kl_bounds_pair_(*args)


@pytest.mark.parametrize("mask", ["float", "shape", "device", "strided"])
def test_pair_refuses_a_bad_mask(mask):
    total, count, at, table = _gape_arena(seed=7)
    bad = {"float": torch.ones(TREES), "shape": torch.ones(TREES + 1, dtype=torch.bool),
           "device": torch.ones(TREES, dtype=torch.bool, device=META),
           "strided": torch.ones(2 * TREES, dtype=torch.bool)[::2]}[mask]
    with pytest.raises(ValueError,
                       match=rf"mask must be a contiguous \[{TREES}\] bool tensor on cpu"):
        kl_bounds_pair_(*_bounds(total.shape), total, count, at, table, bad)


@pytest.mark.parametrize("count_value", [EPISODES + 2, -1])
def test_pair_refuses_a_count_outside_the_table(count_value):
    total, count, at, table = _gape_arena(seed=8)
    count[TREES // 2, at[DEPTHS - 1, TREES // 2]] = count_value
    with pytest.raises(IndexError, match="a count outside the threshold table of 22 entries"):
        kl_bounds_pair_(*_bounds(total.shape), total, count, at, table)


@pytest.mark.parametrize("offset", [int(np.prod(GRAPH)), -1])
def test_pair_refuses_an_offset_outside_the_row(offset):
    total, count, at, threshold = _gbop_arena(seed=9)
    at[TREES // 2] = offset  # a negative offset must not wrap to the row's end
    with pytest.raises(RuntimeError, match=f"index {offset} is out of bounds"):
        kl_bounds_pair_(*_bounds(total.shape), total, count, at, threshold)


def test_pair_on_cpu_never_touches_the_build(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(kl_module, "build", forbidden)
    monkeypatch.setattr(kl_module, "_load", forbidden)
    monkeypatch.setattr(kl_module.subprocess, "run", forbidden)
    before = kl_module.kl_bounds_pair_.launches
    total, count, at, table = _gape_arena(seed=10)
    ucb, _ = kl_module.kl_bounds_pair_(*_bounds(total.shape), total, count, at, table)
    assert ucb.device.type == "cpu" and kl_module.kl_bounds_pair_.launches == before


def _counting(monkeypatch, module):
    calls = []

    def counting(ucb, lcb, _sum, count, at, threshold, mask=None, **options):
        calls.append((at.clone(), threshold.clone(), mask))
        return kl_bounds_pair_(ucb, lcb, _sum, count, at, threshold, mask, **options)

    monkeypatch.setattr(module, "kl_bounds_pair_", counting)
    return calls


def test_mdp_gape_solves_once_per_episode(monkeypatch):
    """One call per episode over the path ``[H, B]`` (nodes at depths 1..H),
    under the trees still planning, with the table of every count; the plan
    equals the one without the counting wrapper."""
    env, params = torch_mdp.params_from_config(LOOP_CONFIG, device="cpu")
    trees = 9
    s = np.random.default_rng(0).integers(0, 4, trees)
    states = torch_mdp.MDPState(s=torch.tensor(s), t=torch.zeros(trees, dtype=torch.int64),
                                done=torch.zeros(trees, dtype=torch.bool))
    noise = np.random.default_rng(1).gumbel(size=(13, 3, trees, 3)).astype(np.float32)
    kw = dict(num_actions=3, episodes=12, horizon=3, gamma=0.8, accuracy=2.2, confidence=0.5,
              transition_threshold_coeff=0.1, width=1, noise=noise, device="cpu")
    want = gape_module.mdp_gape_plan(env, params, states, None, **kw)
    calls = _counting(monkeypatch, gape_module)
    got = gape_module.mdp_gape_plan(env, params, states, None, **kw)
    assert len(calls) == kw["episodes"] + 1
    for at, table, mask in calls:
        assert at.shape == (kw["horizon"], trees) and table.shape == (kw["episodes"] + 2,)
        assert mask.shape == (trees,)
        np.testing.assert_array_equal(got[2].d_depth.gather(1, at.t()).t()[:, mask],
                                      np.arange(1, kw["horizon"] + 1)[:, None].repeat(
                                          int(mask.sum()), 1))
    assert not calls[-1][2].all()  # some trees stopped early and were masked out
    for a, b in zip((*got[:2], *got[2]), (*want[:2], *want[2])):
        assert torch.equal(a, b)


def test_gbop_solves_once_per_step(monkeypatch):
    """One call per (episode, depth) step at the B visited entries, with the
    scalar reward threshold and no mask."""
    env, params = torch_mdp.params_from_config(LOOP_CONFIG, device="cpu")
    trees = 6
    s = np.random.default_rng(2).integers(0, 4, trees)
    states = torch_mdp.MDPState(s=torch.tensor(s), t=torch.zeros(trees, dtype=torch.int64),
                                done=torch.zeros(trees, dtype=torch.bool))
    kw = dict(num_actions=3, episodes=4, horizon=3, gamma=0.8, accuracy=1e-2,
              reward_threshold_coeff=1.0, transition_threshold_coeff=0.1, width=2,
              device="cpu")
    obs = env.observe(params, states)
    want = gbop_module.gbop_stochastic_plan(env, params, states, obs,
                                            torch.Generator().manual_seed(0), **kw)
    calls = _counting(monkeypatch, gbop_module)
    got = gbop_module.gbop_stochastic_plan(env, params, states, obs,
                                           torch.Generator().manual_seed(0), **kw)
    assert len(calls) == kw["episodes"] * kw["horizon"]
    for at, threshold, mask in calls:
        assert at.shape == (trees,) and threshold.dim() == 0 and mask is None
        assert ((at >= 0) & (at < got[1].sa_count[0].numel())).all()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
