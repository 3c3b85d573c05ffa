"""The cell ``gbop-sailing.batch4096`` on the CPU at a small size: a sound
run is correct, untraced and traced, and its traced line carries every
per-layer metric of the cell (the paired KL kernel's share of its roofline
from a stand-in: on the CPU the kernel is the plain version, which the
profiler records as no operator of its own, so its calls are marked with a
``record_function`` of the kernel's name); the control (the reference in
bfloat16 in the program's place) and a plan altered where it is produced
are not correct; the adapters' work, draws and counts give what a count by
hand gives; and the cell's two metric readers read made-up records."""
import collections
import types

import pytest
import torch

from perfbench.control import readings
from perfbench.counts import gbop_stochastic as counts
from perfbench.counts import kl_pair
from perfbench.pbcore import cell
from perfbench.pbcore import draws as draw
from perfbench.pbcore.cell import Context
from perfbench.pbcore.manifest import Manifest, peaks
from perfbench.pbcore.rehearse import rehearse
from perfbench.pbcore.spans import SpannedSegment
from perfbench.tests.conftest import ROOT

CELL = "gbop-sailing.batch4096"
PROGRAM_METRICS = ("planner.vi_sweeps_per_plan.batch", "device.idle_in_gbop_share.batch",
                   "host.syncs_per_plan.batch")


def failed(checks: dict) -> list:
    return [name for name, c in checks.items() if not c["value"] <= c["limit"]]


def _context(seed=0):
    manifest = Manifest(ROOT)
    return Context(manifest, manifest.cell(CELL), seed, torch.device("cpu"), None)


@pytest.fixture
def marked_kernel(monkeypatch):
    """The plain version of the paired KL kernel recorded by the profiler
    under the kernel's name, as its launch is on the card."""
    from rl_agents_torch.ops import kl_bound

    plain = kl_bound.kl_bounds_pair_torch_

    def marked(*args, **kwargs):
        with torch.profiler.record_function("kl_bounds_pair_kernel"):
            return plain(*args, **kwargs)

    monkeypatch.setattr(kl_bound, "kl_bounds_pair_torch_", marked)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace, monkeypatch, marked_kernel):
    # the shares of the peak read the card's peaks: the H100's here
    monkeypatch.setattr(cell, "peaks", lambda kind: peaks("NVIDIA H100 80GB HBM3"))
    result = rehearse(ROOT, CELL, 2**32 + 21, seconds=0.2, trace=trace)["result"]
    assert result["correct"]
    assert result["compared"]["trees_differing"]["value"] == 0
    assert result["compared"]["value_gap"]["value"] == 0.0
    if trace:
        wanted = {m["name"] for m in Manifest(ROOT).per_layer(CELL)}
        assert wanted == set(result["metrics"])
        for name in PROGRAM_METRICS:
            assert result["metrics"][name]["value"] > 0, name
        assert 0 < result["metrics"]["kl_bounds_pair_roofline"]["value"] <= 105
        # eagerly, one read-back a sweep beside the four host values and the last read
        sweeps = result["metrics"]["planner.vi_sweeps_per_plan.batch"]["value"]
        assert 3 <= sweeps <= 60
        assert result["metrics"]["host.syncs_per_plan.batch"]["value"] == 4 + sweeps + 1
    else:
        assert {"setup_s", "plan_rate"} == set(result["metrics"])


def test_the_control_is_not_correct():
    checks = readings(ROOT, CELL, 2**31 + 5, 0.3, torch.device("cpu"), {"trees": 8})
    assert failed(checks)


def action_changed(config, out):
    out["actions"][0] = (out["actions"][0] + 1) % config["sizes"]["num_actions"]


def bound_nudged(config, out):
    out["value_upper"][0, 0] += 0.01


def slot_moved(config, out):
    out["sa_child"][0, 0, 0, 0] = out["sa_child"][0, 0, 0, 0] + 1


class FrozenEnv:
    """The program's env whose step returns the state it was given."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, params, state, *args, **kwargs):
        out = self.env.step(params, state, *args, **kwargs)
        return out._replace(state=state, obs=self.env.observe(params, state))


@pytest.mark.parametrize("fault", [action_changed, bound_nudged, slot_moved, "state unchanged"])
def test_a_plan_altered_where_it_is_produced_is_not_correct(fault):
    planner = _context().planner

    def program(config, env, params, states0, drawn, device, units_run=None):
        if fault == "state unchanged":
            return planner.program_plan(config, FrozenEnv(env), params, states0, drawn, device,
                                        units_run)
        out = planner.program_plan(config, env, params, states0, drawn, device, units_run)
        fault(config, out)
        return out

    out = rehearse(ROOT, CELL, 2**31 + 17, seconds=0.05, program=program)
    assert out["result"]["correct"] is False and failed(out["checks"])


def test_the_adapters_work_and_draws():
    ctx = _context()
    planner, config = ctx.planner, ctx.config
    assert planner.units(config) == 3
    assert planner.work(config, 4096) == 4096 * 3 * 55 == 675840
    gen = lambda: draw.generator(2**33 + 1, draw.PLAN, 0, torch.device("cpu"))
    drawn = planner.plan_draws(config, 16, gen())
    assert drawn["noise"].shape == (3, 55, 16, 8) and drawn["final_noise"].shape == (16, 8)
    assert drawn["env_noise"].shape == (3, 55, 16)
    assert 0 <= float(drawn["env_noise"].min()) and float(drawn["env_noise"].max()) < 1
    again = planner.plan_draws(config, 16, gen())
    assert all(torch.equal(drawn[k], again[k]) for k in drawn)
    # the boats start short of the goal's row and column, winds over the 8
    pos, wind = ctx.env.scene_draws(draw.generator(5, draw.SCENES, 0, torch.device("cpu")),
                                    4096, ctx.model)
    assert pos.shape == (4096, 2) and int(pos.min()) == 0 and int(pos.max()) == 6
    assert sorted(wind.unique().tolist()) == list(range(8))
    rows, actions = planner.transition_rows(config, "states", drawn)
    assert rows == "states" and torch.equal(actions, drawn["noise"][0, 0].argmax(dim=-1))


def test_the_counts_match_a_count_by_hand():
    # 2 graphs, 2 actions, 1 slot, 1 episode of horizon 2, observations of 3, one sweep
    step = 2 * (2 * 3 + 8 + 2) + 2 * (8 * 1 + 2 + 3) + 12 + 2 * 1 + 8
    nodes = 2 + 1 * 2
    sweep = nodes * (2 * (8 * 1 + 2) + 8)
    pair = 2 * (4 + 18) * 2  # both bounds of the 2 graphs' entries
    assert counts.plan_ops(2, 2, 1, 1, 2, 3, 1) == 2 * (2 * step + sweep) + 2 * pair == 720
    draws = (1 * 2 * (2 + 1) + 2) * 4
    arena = nodes * (32 + 17 + 32 + 2 * (16 + 36 * 1))
    swept = nodes * (2 * (24 * 1 + 8) + 17)
    assert counts.plan_bytes(2, 2, 1, 1, 2, 3, 1) == 2 * (draws + arena + swept + 32 + 12 + 8) \
        == 2 * (32 + 740 + 324 + 52)
    # the cell's launch: 4096 entries, no mask, a 0-d threshold
    planner, config = _context().planner, Manifest(ROOT).config("gbop-sailing")
    launch = planner.kernel_counts(config, 4096)["kl_bounds_pair"]
    assert launch["bytes"] == 28 * 4096 + 4 == 114692
    assert launch["ops"] == kl_pair.launch_ops(4096) == 2 * 22 * 4096
    ops, nbytes = planner.plan_counts(config, 4096)
    assert ops == counts.plan_ops(4096, 8, 1, 3, 55, 10, 1) and nbytes > 4096 * 167 * 8 * 36


class Span:  # the fields of rl_agents_torch.trainer.profiling.Span that the readers read
    def __init__(self, name, start_ns=0, end_ns=0):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns


def _read(metric, made):
    return Manifest(ROOT).module("metrics", metric).read({"program": made})


@pytest.mark.parametrize("counters, plans, expected", [
    ({"gbop_stochastic.vi_sweeps": 120, "host.syncs": 10}, 2, 60.0),
    ({"gbop_stochastic.vi_sweeps": 41}, 1, 41.0),
    ({"host.syncs": 5}, 1, None),
    ({"gbop_stochastic.vi_sweeps": 60}, 0, None),
])
def test_the_sweeps_per_plan(counters, plans, expected):
    made = {"counters": counters, "spans": [Span("planner.plan")] * plans + [Span("gbop.root")]}
    assert _read("planner.vi_sweeps_per_plan.batch", made) == expected
    assert _read("planner.vi_sweeps_per_plan.batch", None) is None


def test_the_idle_share_under_the_planners_spans():
    # kernels cover [10, 20] and [60, 70] of the window [0, 100]; the plan
    # holds a replayed episode [5, 50] and the root's choice [80, 95]: idle
    # [5, 10], [20, 50] and [80, 95] under gbop.*, 50 of 80
    spans = [Span("planner.plan", 0, 100), Span("gbop.episode", 5, 50), Span("gbop.root", 80, 95)]
    segment = SpannedSegment([("k", 10, 20), ("k", 60, 70)], spans, (0, 100))
    made = {"segment": segment, "spans": [], "counters": {}}
    assert _read("device.idle_in_gbop_share.batch", made) == pytest.approx(62.5)
    other = SpannedSegment(segment.kernels, [Span("gape.episode", 5, 50)], (0, 100))
    assert _read("device.idle_in_gbop_share.batch", dict(made, segment=other)) is None
    assert _read("device.idle_in_gbop_share.batch", None) is None
