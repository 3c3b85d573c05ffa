"""The port's tracing (``rl_agents_torch/trainer/profiling.py``): spans off
and on, their nesting, their clock against the profiler's, ``host.syncs`` at
the blocking reads of the benchmark's paths, the counters at their sites,
and ``trace()``'s Chrome trace.

Two tests need a CUDA card (marker ``card``; they skip without one): a span
around a kernel encloses the kernel's profiled interval, and ``host.syncs``
equals the synchronisations that ``torch.cuda.set_sync_debug_mode`` reports
inside the program's calls. Run them on the card with
``python -m pytest tests/test_torch_tracing.py -m card``."""
import json
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rl_agents_torch.agents.dynamic_programming import bellman
from rl_agents_torch.agents.tree_search.batch import olop_plan_batch, opd_plan_batch
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.trainer import profiling
from rl_agents_torch.trainer.profiling import counters, span
from rl_agents_torch.utils.math import newton_iteration

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
# the benchmark's highway scene and OPD agent (perfbench/configs/opd-highway.json)
HIGHWAY = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
OPD_AGENT = {"__class__": "DeterministicPlannerAgent", "budget": 100, "gamma": 0.9}
EXPANSIONS = 20  # budget 100 over 5 actions


@pytest.fixture
def recording():
    """Tracing on for the test, off and emptied after it."""
    profiling.take()
    profiling.enable()
    yield
    profiling.disable()
    profiling.take()


def test_off_records_nothing_and_returns_one_object():
    profiling.disable()
    profiling.take()
    first, second = span("agent.act"), span("env.step")
    assert first is second
    with first:
        with span("planner.plan"):
            pass
    assert profiling.take() == []


def test_spans_nest_and_close_on_an_exception(recording):
    with span("agent.act"):
        with span("planner.plan"):
            with span("env.transition"):
                pass
            with pytest.raises(ValueError):
                with span("env.transition"):
                    raise ValueError("inside")
        with span("env.step"):
            pass
    with span("agent.act"):
        pass
    spans = profiling.take()
    assert [s.name for s in spans] == ["agent.act", "planner.plan", "env.transition",
                                       "env.transition", "env.step", "agent.act"]
    assert [s.parent for s in spans] == [-1, 0, 1, 1, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 0, 0, 5]
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert spans[3].end_ns <= spans[4].start_ns  # closed by the exception
    assert profiling.take() == []


def test_a_profiled_op_lies_inside_the_span_that_issued_it(recording):
    """The spans' clock is the profiler's: an ATen op placed by
    ``trace_start_ns`` falls inside the span around it."""
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("matmul"):
            a @ a
    (s,) = profiling.take()
    base = prof.profiler.kineto_results.trace_start_ns()
    (op,) = [e for e in prof.events() if e.cpu_parent is None and e.name == "aten::matmul"]
    assert s.start_ns <= base + op.time_range.start * 1e3
    assert base + op.time_range.end * 1e3 <= s.end_ns


def _opd_agent(device):
    handle = load_environment(dict(HIGHWAY), device=device)
    agent = load_agent(dict(OPD_AGENT), handle, device=device)
    agent.seed(0)
    return handle, agent


def _syncs_of(run):
    """``(host.syncs, opd.sweeps)`` that ``run`` adds."""
    before = counters.copy()
    run()
    delta = counters - before
    return delta["host.syncs"], delta["opd.sweeps"]


def test_host_syncs_count_the_blocking_reads_of_an_act_a_step_and_a_plan():
    handle, agent = _opd_agent("cpu")
    obs = handle.obs[0].numpy()
    # an act: the plan's four constants, one leaf write an expansion, one read
    # a consolidation sweep, and the plan's two read-backs; the transition
    # copies nothing to the card
    syncs, sweeps = _syncs_of(lambda: agent.act(obs))
    assert sweeps > 0 and syncs == 4 + EXPANSIONS + sweeps + 2
    # a step: the action's copy, the observation, three infos, the reward,
    # terminated and truncated
    syncs, _ = _syncs_of(lambda: handle.step(0))
    assert syncs == 1 + 1 + 3 + 3
    # a KL-OLOP batch plan: two at its start (the B-value table and gamma),
    # none in its transitions
    states = tuple(x.expand(4, *x.shape[1:]) for x in handle.state)
    states = type(handle.state)(*states)
    syncs, _ = _syncs_of(lambda: olop_plan_batch(
        handle.functional, handle.params, states, torch.Generator().manual_seed(0),
        num_actions=5, episodes=6, horizon=3, gamma=0.7, threshold_coeff=2.0,
        continuation_uniform=True, device="cpu"))
    assert syncs == 2


def _finite_mdp(models: int):
    """Deterministic two-state chains, ``models`` of them stacked."""
    shape = (models,) if models else ()
    return bellman.BellmanModel(
        transition=torch.tensor([[1], [0]]).expand(*shape, 2, 1),
        reward=torch.tensor([[1.0], [0.0]]).expand(*shape, 2, 1),
        terminal=torch.zeros(*shape, 2, dtype=torch.bool), next=torch.zeros(()))


def _sailing_act(agent_file):
    handle = load_environment(CONFIGS / "SailingEnv" / "env.json", device="cpu")
    agent = load_agent(CONFIGS / "SailingEnv" / "agents" / agent_file, handle, device="cpu")
    agent.seed(0)
    agent.act(handle.obs[0].numpy())


COUNTED = {
    "opd": (lambda: _opd_agent("cpu")[1].act(None), ["opd.sweeps"]),
    "gbop_d": (lambda: _sailing_act("gbop-d.json"),
               ["gbop_d.vi_calls", "gbop_d.vi_sweeps", "gbop_d.vi_tree_sweeps"]),
    "gbop_stochastic": (lambda: _sailing_act("gbop.json"),
                        ["gbop_stochastic.vi_calls", "gbop_stochastic.vi_sweeps",
                         "gbop_stochastic.vi_tree_sweeps"]),
    "newton": (lambda: newton_iteration(lambda x: x * x - 2.0, lambda x: 2.0 * x, 1e-4,
                                        x0=torch.ones(4), a=0.0, b=10.0),
               ["newton_iteration.calls", "newton_iteration.trips"]),
    "value_iteration": (lambda: bellman.state_action_value(_finite_mdp(0), 0.5,
                                                           "deterministic"),
                        ["state_action_value.iterations"]),
    "robust_value_iteration": (lambda: bellman.robust_state_action_value(
        _finite_mdp(2), 0.5, "deterministic"), ["robust_state_action_value.iterations"]),
}


@pytest.mark.parametrize("site", sorted(COUNTED))
def test_each_counter_counts_at_its_site(site):
    run, keys = COUNTED[site]
    before = counters.copy()
    run()
    delta = counters - before
    for key in keys:
        assert delta[key] > 0, key
    # the plain versions of the KL kernel ran: no launch counted on the CPU
    assert not any(key.endswith(".launches") for key in delta), delta


def test_trace_writes_the_spans_and_counters_into_the_chrome_trace(tmp_path):
    handle, agent = _opd_agent("cpu")
    profiling.disable()
    with profiling.trace(tmp_path) as prof:
        agent.act(None)
        handle.step(0)
    assert prof is not None
    data = json.loads((tmp_path / "trace.json").read_text())
    spans = [e for e in data["traceEvents"] if e.get("cat") == "span"]
    names = [e["name"] for e in spans]
    assert names[:2] == ["agent.act", "planner.plan"] and names[-1] == "env.step"
    assert names.count("env.transition") == EXPANSIONS
    act = spans[0]
    assert act["args"]["parent"] == -1 and spans[1]["args"]["parent"] == act["args"]["index"]
    ops = [e for e in data["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and all(act["ts"] <= e["ts"] for e in ops if e["name"] == "aten::argmax")
    counted = data["otherData"]["counters"]
    assert counted["host.syncs"] > 0 and counted["opd.sweeps"] > 0
    assert profiling.take() == [] and span("x") is span("y")  # tracing is off again


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_a_span_around_a_kernel_encloses_its_profiled_interval(recording):
    dev = _card()
    a = torch.randn(4096, 4096, device=dev)
    a @ a
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler's start holds the next launch about 1.7 ms: let it pass first
        torch.cuda.synchronize(dev)
        with span("matmul"):
            a @ a
            torch.cuda.synchronize(dev)
    (s,) = profiling.take()
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"span {s.start_ns} .. {s.end_ns}, profiler base {base}, {len(kernels)} kernels")
    assert kernels
    for kernel in kernels:
        start = base + kernel.time_range.start * 1e3
        end = base + kernel.time_range.end * 1e3
        print(f"{kernel.name[:60]}: starts {start - s.start_ns:.0f} ns after the span's start, "
              f"ends {s.end_ns - end:.0f} ns before its end")
        assert s.start_ns <= start and end <= s.end_ns
        assert start - s.start_ns < 1e6


@pytest.mark.card
def test_host_syncs_equal_the_synchronisations_cuda_reports():
    """Four agent steps of the benchmark's OPD agent, one OPD batch plan and
    one KL-OLOP batch plan: ``host.syncs`` rises by the number of
    synchronising operations ``set_sync_debug_mode("warn")`` reports."""
    dev = _card()
    handle, agent = _opd_agent(dev)
    states = type(handle.state)(*(x.expand(512, *x.shape[1:]).contiguous()
                                  for x in handle.state))
    opd = lambda: opd_plan_batch(handle.functional, handle.params, states,
                                 torch.Generator(device=dev).manual_seed(0), num_actions=5,
                                 expansions=EXPANSIONS, gamma=0.9, plan_capacity=EXPANSIONS,
                                 device=dev)
    olop = lambda: olop_plan_batch(handle.functional, handle.params, states,
                                   torch.Generator(device=dev).manual_seed(0), num_actions=5,
                                   episodes=72, horizon=6, gamma=0.7, threshold_coeff=2.0,
                                   continuation_uniform=True, device=dev)

    obs = [handle.obs[0].cpu().numpy()]

    def steps():
        for _ in range(4):
            obs[0], _, done, truncated, _ = handle.step(agent.act(obs[0]))
            assert not (done or truncated)

    for name, run in (("agent steps", steps), ("OPD batch plan", opd),
                      ("KL-OLOP batch plan", olop)):
        run()  # the first call builds the KL kernel
        torch.cuda.synchronize(dev)
        before = counters["host.syncs"]
        # set outside the recording: the mode's first setting in a process
        # reports one synchronisation of its own
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        reported = sum("synchroniz" in str(w.message) for w in caught)
        counted = counters["host.syncs"] - before
        print(f"{name}: {counted} counted, {reported} reported")
        assert counted == reported > 0
