"""The cell ``mdp-gape-garnet.batch4096`` on the CPU at a small size: a sound
run is correct, untraced and traced, and its traced line carries every
per-layer metric of the cell (the paired KL kernel's share of its roofline
from a stand-in: on the CPU the kernel is the plain version, which the
profiler records as no operator of its own, so its calls are marked with a
``record_function`` of the kernel's name); the control (the reference in
bfloat16 in the program's place) and a plan altered where it is produced
are not correct; and ``counts/mdp_gape.py`` and ``counts/kl_pair.py`` give
what a count by hand gives."""
import collections

import pytest
import torch

from perfbench.control import readings
from perfbench.counts import kl_pair
from perfbench.counts import mdp_gape as counts
from perfbench.pbcore import cell
from perfbench.pbcore.cell import Context
from perfbench.pbcore.manifest import Manifest, peaks
from perfbench.pbcore.rehearse import rehearse
from perfbench.tests.conftest import ROOT

CELL = "mdp-gape-garnet.batch4096"
PROGRAM_METRICS = ("planner.gape_backup_span_ms.batch", "planner.newton_trips_per_plan.batch",
                   "device.idle_in_gape_share.batch", "host.syncs_per_plan.batch")


def failed(checks: dict) -> list:
    return [name for name, c in checks.items() if not c["value"] <= c["limit"]]


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
        # 21 x 5 chance backups: one Newton solve each, whose trips end at a
        # block's read-back on the CPU, beside the plan's five host values
        trips = result["metrics"]["planner.newton_trips_per_plan.batch"]["value"]
        assert trips % 8 == 0 and trips >= 8 * 105
        assert result["metrics"]["host.syncs_per_plan.batch"]["value"] == 5 + trips / 8
    else:
        assert {"setup_s", "plan_rate"} == set(result["metrics"])


def test_a_planner_without_its_spans_leaves_their_metrics_out(monkeypatch):
    """As the parent of the planner's spans would run (were its env's reset
    to take the start states): the run is correct, and the metrics read
    from the planner's spans are left out."""
    from rl_agents_torch.agents.tree_search import mdp_gape
    from rl_agents_torch.trainer import profiling

    monkeypatch.setattr(mdp_gape, "span", lambda name: profiling._OFF)
    monkeypatch.setattr(mdp_gape, "counters", collections.Counter())
    result = rehearse(ROOT, CELL, 2**31 + 23, seconds=0.1, trace=True)["result"]
    assert result["correct"]
    assert "device.idle_share.batch" in result["metrics"]
    for name in PROGRAM_METRICS:
        assert name not in result["metrics"], name


def test_the_control_is_not_correct():
    checks = readings(ROOT, CELL, 2**31 + 5, 0.3, torch.device("cpu"), {"trees": 8})
    assert failed(checks)


def action_changed(config, out):
    out["actions"][0] = (out["actions"][0] + 1) % config["sizes"]["num_actions"]


def value_nudged(config, out):
    out["c_value_upper"][0, 0] += 0.01


def slot_moved(config, out):
    out["c_children"][0, 0] = out["c_children"][0, 0].flip(0)


class FrozenEnv:
    """The program's env whose step returns the state it was given."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, params, state, *args, **kwargs):
        out = self.env.step(params, state, *args, **kwargs)
        return out._replace(state=state, obs=state.s)


def _planner():
    manifest = Manifest(ROOT)
    return Context(manifest, manifest.cell(CELL), 0, torch.device("cpu"), None).planner


@pytest.mark.parametrize("fault", [action_changed, value_nudged, slot_moved, "state unchanged"])
def test_a_plan_altered_where_it_is_produced_is_not_correct(fault):
    planner = _planner()

    def program(config, env, params, states0, drawn, device, units_run=None):
        if fault == "state unchanged":
            return planner.program_plan(config, FrozenEnv(env), params, states0, drawn, device,
                                        units_run)
        out = planner.program_plan(config, env, params, states0, drawn, device, units_run)
        fault(config, out)
        return out

    out = rehearse(ROOT, CELL, 2**31 + 17, seconds=0.05, program=program)
    assert out["result"]["correct"] is False and failed(out["checks"])


def test_the_counts_match_a_count_by_hand():
    # 2 trees, 2 actions, 2 slots, 2 branches, 1 episode (2 run) of horizon 2
    step = 5 * 2 + 3 * 2 + 4 + 8 + 2 * 2 + 6
    episode = 2 * (step + 2 * 2 + 2 * (6 + 8 + 5) * 2) + 4 * 2
    pair = 2 * (4 + 18) * (2 * 2)  # both bounds of the path's 4 entries
    assert counts.plan_ops(2, 2, 2, 2, 1, 2) == 2 * 2 * episode + 2 * pair == 1328
    decision, chance = 1 + 2 * 2, 1 + 5 * 2
    arena = decision * (8 * 5 + 4 * 5 + 1) + chance * (8 * 8 + 4 * 2)
    draws = 2 * 2 * (2 + 2) * 4
    assert counts.plan_bytes(2, 2, 2, 2, 1, 2) == 2 * (draws + arena + 4 * 8) == 2386
    # the cell's launch: 5 x 4096 entries, the mask and a table of 22 counts
    assert kl_pair.launch_bytes(5 * 4096, 4096, 22) == 28 * 20480 + 4096 + 4 * 22 == 577624
    assert kl_pair.launch_ops(5 * 4096) == 2 * 22 * 20480
    planner = _planner()
    config = Manifest(ROOT).config("mdp-gape-garnet")
    assert planner.work(config, 4096) == 4096 * 21 * 5 == 430080
    assert planner.kernel_counts(config, 4096)["kl_bounds_pair"]["bytes"] == 577624
