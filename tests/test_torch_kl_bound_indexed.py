"""The indexed KL-bound form ``kl_bound_indexed_`` (one launch per OLOP
episode over the episode's path in the tree arena): its plain version against
per-depth solves and against the Pallas kernel in interpret mode, its input
checks, and the planner's one call per episode.

The tolerance against Pallas is 1e-5, not 0: XLA's and torch's ``log`` (and
XLA's fused multiply-adds) differ by ulps."""
import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search import olop as olop_module
from rl_agents_torch.agents.tree_search.olop import olop_plan
from rl_agents_torch.envs import finite_mdp as torch_mdp
from rl_agents_torch.ops import cuda_build
from rl_agents_torch.ops import kl_bound as kl_module
from rl_agents_torch.ops.kl_bound import kl_bound_indexed_, kl_bound_torch
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS
from rl_agents_tpu.ops.pallas_kl import kl_bound_pallas

torch.set_num_threads(1)

ATOL = 1e-5
TREES, WIDTH, DEPTHS = 13, 40, 5
SENTINEL = -7.0
# tests/agents/tree_search/test_plan_batch_scale.py:28-33
LOOP_CONFIG = {
    "mode": "deterministic",
    "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
    "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
    "terminal": [0, 0, 0, 0],
    "max_episode_steps": 1000,
}


def _arena(seed=0, trees=TREES, width=WIDTH, depths=DEPTHS):
    """OLOP-like node statistics in a ``[trees, width]`` arena (counts 0..23,
    sums of Bernoulli rewards), a path of distinct nodes per tree and a
    threshold 4 log t, all made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 24, (trees, width))
    total = np.floor(rng.random((trees, width)) * (count + 1)).astype(np.float32)
    nodes = np.argsort(rng.random((trees, width - 1)), axis=1)[:, :depths].T + 1
    thr = np.float32(4.0 * np.log(rng.integers(1, 24)))
    return (torch.tensor(total), torch.tensor(count), torch.tensor(np.ascontiguousarray(nodes)),
            torch.tensor(thr))


def _out(shape):
    return torch.full(shape, SENTINEL)


@pytest.mark.parametrize("iters", [24, NEWTON_MAX_ITERATIONS])
@pytest.mark.parametrize("lower", [False, True])
def test_indexed_equals_gather_solve_scatter_per_depth(lower, iters):
    total, count, nodes, thr = _arena()
    got = kl_bound_indexed_(_out(total.shape), total, count, nodes, thr, lower=lower, iters=iters)
    # the planner's former form: one [B] solve per depth, scattered in turn
    want = _out(total.shape)
    rows = torch.arange(TREES)
    for h in range(DEPTHS):
        want[rows, nodes[h]] = kl_bound_torch(total[rows, nodes[h]],
                                              count[rows, nodes[h]].to(torch.float32), thr,
                                              lower=lower, iters=iters)
    assert torch.equal(got, want)


@pytest.mark.parametrize("iters", [24, NEWTON_MAX_ITERATIONS])
@pytest.mark.parametrize("lower", [False, True])
def test_indexed_matches_pallas_interpret(lower, iters):
    total, count, nodes, thr = _arena(seed=1)
    got = kl_bound_indexed_(_out(total.shape), total, count, nodes, thr, lower=lower, iters=iters)
    rows = torch.arange(TREES).expand_as(nodes)
    s, n = total[rows, nodes].numpy(), count[rows, nodes].numpy().astype(np.float32)
    want = np.asarray(kl_bound_pallas(s, n, thr.numpy(), lower=lower, iters=iters,
                                      interpret=True))
    err = np.abs(got[rows, nodes].numpy() - want)
    worst = np.unravel_index(int(np.argmax(err)), err.shape)
    assert err[worst] <= ATOL, (f"path entry {worst}: sum={s[worst]!r} count={n[worst]!r}: "
                                f"port {got[rows, nodes].numpy()[worst]!r} vs JAX {want[worst]!r}")


def test_indexed_leaves_entries_off_the_path_untouched():
    total, count, nodes, thr = _arena(seed=2)
    before = torch.randn(total.shape, generator=torch.Generator().manual_seed(0))
    got = kl_bound_indexed_(before.clone(), total, count, nodes, thr)
    on_path = torch.zeros(total.shape, dtype=torch.bool)
    on_path[torch.arange(TREES).expand_as(nodes), nodes] = True
    assert int(on_path.sum()) == TREES * DEPTHS  # the nodes of a tree are distinct
    assert torch.equal(got[~on_path], before[~on_path])
    assert ((got[on_path] >= 0) & (got[on_path] <= 1)).all()


def test_indexed_returns_out_and_handles_an_empty_path():
    total, count, nodes, thr = _arena(seed=3)
    out = _out(total.shape)
    assert kl_bound_indexed_(out, total, count, nodes, thr) is out
    empty = torch.zeros((0, TREES), dtype=torch.int64)
    assert torch.equal(kl_bound_indexed_(_out(total.shape), total, count, empty, thr),
                       _out(total.shape))


META = torch.device("meta")
# case -> (what the error says, how the good inputs out, sum, count, nodes, thr are spoiled)
BAD_INPUTS = {
    "count as f32": ("count must be 2-d torch.int64",
                     lambda o, s, c, n, t: (o, s, c.float(), n, t)),
    "sum as f64": ("sum must be 2-d torch.float32",
                   lambda o, s, c, n, t: (o, s.double(), c, n, t)),
    "nodes as i32": ("nodes must be 2-d torch.int64",
                     lambda o, s, c, n, t: (o, s, c, n.int(), t)),
    "threshold not 0-d": ("threshold must be 0-d",
                          lambda o, s, c, n, t: (o, s, c, n, t.reshape(1))),
    "threshold a float": ("threshold must be a tensor",
                          lambda o, s, c, n, t: (o, s, c, n, float(t))),
    "sum of another shape": (r"one \[B, N\] shape",
                             lambda o, s, c, n, t: (o, s[:, :-1].contiguous(), c, n, t)),
    "nodes of another width": (rf"nodes must be \[H, {TREES}\]",
                               lambda o, s, c, n, t: (o, s, c, n[:, :-1].contiguous(), t)),
    "count not contiguous": ("count must be contiguous",
                             lambda o, s, c, n, t: (o, s, c.t().contiguous().t(), n, t)),
    "sum on another device": ("expected one device",
                              lambda o, s, c, n, t: (o, s.to(META), c, n, t)),
    "all on the meta device": ("unsupported device meta",
                               lambda *args: tuple(v.to(META) for v in args)),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_indexed_refuses_bad_inputs(case):
    message, spoil = BAD_INPUTS[case]
    total, count, nodes, thr = _arena()
    args = spoil(_out(total.shape), total, count, nodes, thr)
    with pytest.raises((TypeError, ValueError), match=f"kl_bound_indexed_: .*{message}"):
        kl_bound_indexed_(*args)


@pytest.mark.parametrize("node", [WIDTH, -1])
def test_indexed_refuses_a_node_outside_the_arena(node):
    total, count, nodes, thr = _arena()
    nodes[DEPTHS - 1, TREES // 2] = node  # a negative node must not wrap to the row's end
    out = _out(total.shape)
    with pytest.raises(RuntimeError, match=f"index {node} is out of bounds"):
        kl_bound_indexed_(out, total, count, nodes, thr)


def test_indexed_on_cpu_never_touches_the_build(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(kl_module, "build", forbidden)
    monkeypatch.setattr(kl_module, "_load", forbidden)
    monkeypatch.setattr(cuda_build.subprocess, "run", forbidden)
    before = counters.copy()
    total, count, nodes, thr = _arena()
    out = kl_module.kl_bound_indexed_(_out(total.shape), total, count, nodes, thr)
    assert out.device.type == "cpu"
    assert counters["kl_bound.launches"] == before["kl_bound.launches"]
    assert counters["kl_bound_indexed_.launches"] == before["kl_bound_indexed_.launches"]


@pytest.mark.parametrize("ucb_type", ["kullback-leibler", "hoeffding"])
def test_planner_solves_once_per_episode(monkeypatch, ucb_type):
    env, params = torch_mdp.params_from_config(LOOP_CONFIG, device="cpu")
    trees = 9
    s = np.random.default_rng(0).integers(0, 4, trees)
    states = torch_mdp.MDPState(s=torch.tensor(s), t=torch.zeros(trees, dtype=torch.int64),
                                done=torch.zeros(trees, dtype=torch.bool))
    kw = dict(num_actions=3, episodes=10, horizon=3, gamma=0.8, threshold_coeff=4.0,
              ucb_type=ucb_type, device="cpu")
    want = olop_plan(env, params, states, **kw)

    calls = []

    def counting(out, _sum, count, nodes, threshold, **options):
        calls.append(nodes.clone())
        return kl_bound_indexed_(out, _sum, count, nodes, threshold, **options)

    monkeypatch.setattr(olop_module, "kl_bound_indexed_", counting)
    got = olop_plan(env, params, states, **kw)
    if ucb_type == "kullback-leibler":
        assert len(calls) == kw["episodes"]
        for nodes in calls:
            assert nodes.shape == (kw["horizon"], trees)
            # row h holds the nodes at depth h + 1: distinct within each tree
            np.testing.assert_array_equal(got[2].depth.gather(1, nodes.t()).t(),
                                          np.arange(1, kw["horizon"] + 1)[:, None].repeat(trees, 1))
    else:
        assert calls == []
    for a, b in zip((*got[:2], *got[2]), (*want[:2], *want[2])):
        assert torch.equal(a, b)
