"""The comparison that decides ``correct`` fails where it must, at sizes a
test run holds, on the CPU: the control (the plain reference in bfloat16 in
the program's place), and a run with the timed path broken underneath, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced. (No
cell runs across chips, so none has an exchange between them to leave out.)
The harness's look for a card is skipped: the rest of a run is driven as
it is."""
import pytest
import torch

from perfbench.control import readings
from perfbench.pbcore.rehearse import rehearse
from perfbench.tests.conftest import ROOT

BATCH_CELLS = ("opd-highway.batch4096", "kl-olop-highway.batch4096")
SMALL_OLOP = {"trees": 8}


def failed(checks: dict) -> list:
    return [name for name, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", BATCH_CELLS + ("opd-highway.agent",))
def test_the_control_is_not_correct(cell):
    scale = {"trees": 8} if "batch" in cell else {"scene_pool": 16, "warmup_steps": 1}
    assert failed(readings(ROOT, cell, 2**31 + 5, 0.3, torch.device("cpu"), scale))


@pytest.mark.parametrize("cell", BATCH_CELLS + ("opd-highway.agent",))
def test_a_sound_run_is_correct(cell):
    out = rehearse(ROOT, cell, 2**32 + 9, seconds=0.2)
    assert out["result"]["correct"] and not failed(out["checks"])


class FrozenEnv:
    """The program's env whose transition returns the state it was given."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def transition(self, params, state, *args, **kwargs):
        return self.env.transition(params, state, *args, **kwargs)._replace(state=state)


def state_unchanged(planner):
    def program(config, env, params, states0, drawn, device, units_run=None):
        return planner.program_plan(config, FrozenEnv(env), params, states0, drawn, device,
                                    units_run)
    return program


def half_the_batch(planner):
    """Plans the first half of the trees and repeats it over the second."""
    def program(config, env, params, states0, drawn, device, units_run=None):
        half = states0[0].shape[0] // 2
        first = type(states0)(*(x[:half] for x in states0))
        cut = {k: v[..., :half] for k, v in drawn.items()}
        out = planner.program_plan(config, env, params, first, cut, device, units_run)

        def twice(x):
            return torch.cat([x, x]) if isinstance(x, torch.Tensor) else tuple(map(twice, x))
        return {k: twice(v) for k, v in out.items()}
    return program


def answer_altered(planner):
    """One tree's first action changed after the plan."""
    def program(config, env, params, states0, drawn, device, units_run=None):
        out = planner.program_plan(config, env, params, states0, drawn, device, units_run)
        out["actions"][0, 0] = (out["actions"][0, 0] + 1) % config["sizes"]["num_actions"]
        return out
    return program


@pytest.mark.parametrize("cell", BATCH_CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, answer_altered])
def test_a_broken_batch_plan_is_not_correct(cell, fault):
    from perfbench.pbcore.cell import Context
    from perfbench.pbcore.manifest import Manifest

    manifest = Manifest(ROOT)
    planner = Context(manifest, manifest.cell(cell), 0, torch.device("cpu"), None).planner
    out = rehearse(ROOT, cell, 2**31 + 17, seconds=0.05, program=fault(planner))
    assert out["result"]["correct"] is False and failed(out["checks"])


def step_unchanged(loop):
    """The env's step returns with the env's state as it was."""
    def step(action):
        before = loop.handle.state
        result = loop.handle.step(action)
        loop.handle.state = before
        return result
    return loop.agent.act, step


def action_altered(loop):
    """Every action the agent takes changed where it is produced."""
    return (lambda obs: (loop.agent.act(obs) + 1) % 5), loop.handle.step


@pytest.mark.parametrize("fault", [step_unchanged, action_altered])
def test_a_broken_agent_loop_is_not_correct(fault):
    out = rehearse(ROOT, "opd-highway.agent", 2**31 + 19, seconds=0.3, program=fault)
    assert out["result"]["correct"] is False and failed(out["checks"])
