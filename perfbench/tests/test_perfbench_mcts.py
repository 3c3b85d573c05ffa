"""The cell ``mcts-highway.batch4096`` on the CPU at a small size: a sound
run is correct, untraced and traced, and its traced line carries every
per-layer metric of the cell; the control (the reference in bfloat16 in the
program's place) and a plan altered where it is produced are not correct;
and ``counts/mcts.py`` gives what a count by hand gives."""
import pytest
import torch

from perfbench.control import readings
from perfbench.counts import mcts as counts
from perfbench.pbcore import cell
from perfbench.pbcore.cell import Context
from perfbench.pbcore.manifest import Manifest, peaks
from perfbench.pbcore.rehearse import rehearse
from perfbench.tests.conftest import ROOT

CELL = "mcts-highway.batch4096"


def failed(checks: dict) -> list:
    return [name for name, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace, monkeypatch):
    # the whole plan's share of the peak reads the card's peaks: the H100's here
    monkeypatch.setattr(cell, "peaks", lambda kind: peaks("NVIDIA H100 80GB HBM3"))
    result = rehearse(ROOT, CELL, 2**32 + 21, seconds=0.2, trace=trace)["result"]
    assert result["correct"]
    assert result["compared"]["trees_differing"]["value"] == 0
    assert result["compared"]["value_gap"]["value"] == 0.0
    if trace:
        wanted = {m["name"] for m in Manifest(ROOT).per_layer(CELL)}
        assert wanted == set(result["metrics"])
        for name in ("planner.mcts_step_span_ms.batch", "device.idle_in_mcts_share.batch"):
            assert result["metrics"][name]["value"] > 0, name
        assert result["metrics"]["host.syncs_per_plan.batch"]["value"] == 2
    else:
        assert {"setup_s", "plan_rate"} == set(result["metrics"])


def test_a_planner_without_its_spans_leaves_their_metrics_out(monkeypatch):
    """As the parent of the planner's spans runs: the run is correct, and
    the metrics read from the spans and the step counter are left out."""
    import collections

    from rl_agents_torch.agents.tree_search import mcts_fused
    from rl_agents_torch.trainer import profiling

    monkeypatch.setattr(mcts_fused, "span", lambda name: profiling._OFF)
    monkeypatch.setattr(mcts_fused, "counters", collections.Counter())
    result = rehearse(ROOT, CELL, 2**31 + 23, seconds=0.1, trace=True)["result"]
    assert result["correct"]
    assert "device.idle_share.batch" in result["metrics"]
    for name in ("planner.mcts_step_span_ms.batch", "device.idle_in_mcts_share.batch"):
        assert name not in result["metrics"], name


def test_the_control_is_not_correct():
    checks = readings(ROOT, CELL, 2**31 + 5, 0.3, torch.device("cpu"), {"trees": 8})
    assert failed(checks)


def action_changed(config, out):
    out["actions"][0, 0] = (out["actions"][0, 0] + 1) % config["sizes"]["num_actions"]


def value_nudged(config, out):
    out["value"][0, 0] += 0.01


@pytest.mark.parametrize("fault", [action_changed, value_nudged])
def test_a_plan_altered_where_it_is_produced_is_not_correct(fault):
    manifest = Manifest(ROOT)
    planner = Context(manifest, manifest.cell(CELL), 0, torch.device("cpu"), None).planner

    def program(config, env, params, states0, drawn, device, units_run=None):
        out = planner.program_plan(config, env, params, states0, drawn, device, units_run)
        fault(config, out)
        return out

    out = rehearse(ROOT, CELL, 2**31 + 17, seconds=0.05, program=program)
    assert out["result"]["correct"] is False and failed(out["checks"])


def test_the_counts_match_a_count_by_hand():
    # 2 trees, 3 vehicles, 2 actions, 2 episodes of horizon 3: 12 transitions
    transition_ops = 59 * 3 * 3 + 220 * 3 + 10
    step_ops = 2 * (4 + 4 + 2) + (1 + 2 + 3 + 2 + 2) + (5 * 3 + 3)
    tree_ops = 2 * (3 * step_ops + 4 * (3 + 1)) + 3 * 4 * 2
    assert counts.plan_ops(2, 3, 2, 2, 3) == 12 * transition_ops + 2 * tree_ops == 15100
    scene = 3 * (4 + 4 + 4 + 8 + 1) + 8 + 8 + 1
    arena = (1 + 2 * 2) * (8 + 2 * 8 + 8 + 4 + 4)
    draws = 2 * 3 * 2 * 2 * 4
    tree_bytes = draws + arena + 8 + 3 * 8 + 8
    assert counts.plan_bytes(2, 3, 2, 2, 3) == 12 * (2 * scene + 8 + 4) + 2 * tree_bytes == 2736
