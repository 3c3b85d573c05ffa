"""The highway transition's CUDA graphs (``envs/base.py::TransitionGraphs``,
``envs/highway.py::HighwayEnv.transition``).

On the CPU every call runs the operations eagerly and counts as
``env.transition_graph.eager``. On a card (marker ``card``; the tests skip
without one) each input signature's first call runs eagerly, its second
captures a graph and later calls replay it; every output field of a graphed
call equals the eager one bit for bit. On the card ``transition`` hands
meta-actions of one ego to a hand-written kernel
(``tests/test_torch_highway_kernel.py``), so the card tests drive an env's
graphs directly (``_graphed``), on the forms that keep them and on that one.
Run them on the card with
``python -m pytest tests/test_torch_transition_graphs.py -m card -s``."""
import json
import warnings
from pathlib import Path

import pytest
import torch

from rl_agents_torch.agents.robust.robust import _model_rows
from rl_agents_torch.envs import highway as th
from rl_agents_torch.factory import load_environment
from rl_agents_torch.trainer.profiling import counters

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
HIGHWAY = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
KEYS = ("replays", "captures", "eager")


def _counted(run):
    before = counters.copy()
    out = run()
    delta = counters - before
    return out, {k: delta[f"env.transition_graph.{k}"] for k in KEYS}


def _scenes(env, params, rows: int, seed: int = 0, steps: int = 3):
    """``rows`` states from the seed, stepped eagerly a few times with random
    actions so that lanes change and some egos crash."""
    gen = torch.Generator(device=params.dt.device).manual_seed(seed)
    state, _ = env.reset(params, gen, rows)
    for _ in range(steps):
        state = env._transition_eager(params, state, _actions(env, rows, gen)).state
    return state


def _actions(env, rows: int, gen):
    device = gen.device
    if env.action_type == "continuous":
        return torch.rand((rows, 2), generator=gen, device=device) * 2.0 - 1.0
    shape = (rows,) if env.controlled_vehicles == 1 else (rows, env.controlled_vehicles)
    return torch.randint(0, 5, shape, generator=gen, device=device)


def _leaves(out) -> dict:
    """Every output field of a ``StepOut`` by name."""
    fields = {f"state.{k}": v for k, v in out.state._asdict().items()}
    fields.update(obs=out.obs, reward=out.reward, terminated=out.terminated,
                  truncated=out.truncated)
    fields.update({f"info.{k}": v for k, v in out.info.items()})
    return fields


def _assert_same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        assert torch.equal(got[name], value), name  # a tolerance of exactly 0


# --------------------------------------------------------------------- CPU

@pytest.mark.parametrize("config", [HIGHWAY, {"id": "highway-v0", "controlled_vehicles": 2},
                                    json.loads((CONFIGS / "HighwayEnv" /
                                                "env_continuous.json").read_text())],
                         ids=["meta", "two_egos", "continuous"])
def test_on_the_cpu_every_call_runs_eagerly_and_is_counted(config):
    handle = load_environment(dict(config), device="cpu")
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 6)
    gen = torch.Generator().manual_seed(1)
    action = _actions(env, 6, gen)
    want = env._transition_eager(params, state, action)
    for _ in range(3):
        out, calls = _counted(lambda: env.transition(params, state, action))
        _assert_same_bits(out, want)
        assert calls == {"replays": 0, "captures": 0, "eager": 1}
    assert env._graphs.seen == set() and env._graphs.graphs == {}


def test_the_overriding_envs_keep_their_own_transition():
    """Two-way's transition is its own and stays eager; the intersection's
    ``transition`` is the graphed highway one, its ``step`` its own."""
    assert th.TwoWayEnv.transition is not th.HighwayEnv.transition
    assert th.IntersectionEnv.transition is th.HighwayEnv.transition
    assert th.IntersectionEnv.step is not th.HighwayEnv.step


# -------------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _graphed(env, params, state, action):
    """The graph path of ``transition``, whatever form the call has."""
    return env._graphs(env._transition_eager, params, state, torch.as_tensor(action))


def _graphed_against_eager(env, params, state, action):
    """Three calls with one signature (eager, capture, replay), each equal to
    the eager operations bit for bit; the counters read 1, 1, 1."""
    want = env._transition_eager(params, state, action)
    outs, calls = [], {k: 0 for k in KEYS}
    for _ in range(3):
        out, delta = _counted(lambda: _graphed(env, params, state, action))
        outs.append(out)
        calls = {k: calls[k] + delta[k] for k in KEYS}
    for out in outs:
        _assert_same_bits(out, want)
    assert calls == {"replays": 1, "captures": 1, "eager": 1}


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 5, 4096, 20480])
def test_meta_actions_replay_the_eager_bits(rows):
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, rows)
    action = _actions(env, rows, torch.Generator(device=dev).manual_seed(7))
    _graphed_against_eager(env, params, state, action)


@pytest.mark.card
@pytest.mark.parametrize("config", [
    json.loads((CONFIGS / "HighwayEnv" / "env_continuous.json").read_text()),
    {"id": "highway-v0", "controlled_vehicles": 2}], ids=["continuous", "two_egos"])
def test_the_variants_replay_the_eager_bits(config):
    dev = _card()
    handle = load_environment(dict(config), device=dev)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 512)
    action = _actions(env, 512, torch.Generator(device=dev).manual_seed(7))
    _graphed_against_eager(env, params, state, action)


@pytest.mark.card
def test_per_row_params_of_the_robust_fan_out_replay_the_eager_bits():
    """DROP's children: B trees x A actions x M models, one model's params a row."""
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    B, A = 64, 5
    models = [params] + [params._replace(**{k: torch.full_like(getattr(params, k), v)
                                            for k, v in th.BEHAVIOR_PRESETS[name].items()})
                         for name in ("AggressiveVehicle", "DefensiveVehicle")]
    ensemble = type(params)(*(torch.stack(fields) for fields in zip(*models)))
    M = len(models)
    rows = _model_rows(ensemble, B, A, M)
    state = _scenes(env, params, B * A * M)
    action = torch.arange(A, device=dev)[None, :, None].expand(B, A, M).reshape(-1)
    _graphed_against_eager(env, rows, state, action)
    # the planner builds its rows afresh each plan: the same signature replays
    fresh = type(rows)(*(x.clone() for x in rows))
    out, calls = _counted(lambda: _graphed(env, fresh, state, action))
    _assert_same_bits(out, env._transition_eager(fresh, state, action))
    assert calls == {"replays": 1, "captures": 0, "eager": 0}


@pytest.mark.card
def test_a_replay_leaves_what_earlier_calls_returned():
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    gen = torch.Generator(device=dev).manual_seed(3)
    states = [_scenes(env, params, 256, seed=k) for k in range(3)]
    actions = [_actions(env, 256, gen) for _ in range(3)]
    wants = [env._transition_eager(params, s, a) for s, a in zip(states, actions)]
    outs = [_graphed(env, params, s, a) for s, a in zip(states, actions)]
    # the first call ran eagerly, the second captured, the third replayed
    for out, want in zip(outs, wants):
        _assert_same_bits(out, want)
    assert not torch.equal(outs[0].state.x, outs[2].state.x)
    # a chain of replays, each from the last's output, as OLOP steps an episode
    state, chained = states[0], []
    for a in actions:
        state = _graphed(env, params, state, a).state
        chained.append(state)
    state = states[0]
    for a, got in zip(actions, chained):
        state = env._transition_eager(params, state, a).state
        assert all(torch.equal(x, y) for x, y in zip(got, state))


@pytest.mark.card
def test_inside_another_capture_the_transition_runs_eagerly():
    """A transition inside someone else's graph (the fused actor-learner's)
    is captured into that graph, and the outer graph replays it right."""
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 128)
    gen = torch.Generator(device=dev).manual_seed(5)
    action = _actions(env, 128, gen)
    static_state = type(state)(*(x.clone() for x in state))
    static_action = action.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up outside the capture
        env._transition_eager(params, static_state, static_action)
    torch.cuda.current_stream(dev).wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    before = counters.copy()
    with torch.cuda.graph(outer):
        out = _graphed(env, params, static_state, static_action)
    delta = counters - before
    assert delta["env.transition_graph.eager"] == 1
    assert delta["env.transition_graph.captures"] == delta["env.transition_graph.replays"] == 0
    assert env._graphs.seen == set()
    for k in range(2):
        next_state = _scenes(env, params, 128, seed=10 + k)
        next_action = _actions(env, 128, gen)
        for dst, src in zip(static_state, next_state):
            dst.copy_(src)
        static_action.copy_(next_action)
        outer.replay()
        _assert_same_bits(out, env._transition_eager(params, next_state, next_action))


@pytest.mark.card
def test_the_counters_and_the_limit_of_signatures():
    """One signature: 1 eager call, 1 capture, then replays. The instance
    holds 8 signatures; a ninth runs eagerly on every call, and is counted.
    A capture adds to ``host.syncs`` what CUDA's sync debug mode reports:
    its device synchronise is no transfer, and the mode reports none."""
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    gen = torch.Generator(device=dev).manual_seed(0)
    state = _scenes(env, params, 64)
    action = _actions(env, 64, gen)
    seen = []
    for _ in range(5):
        _, calls = _counted(lambda: _graphed(env, params, state, action))
        seen.append(tuple(calls[k] for k in KEYS))
    assert seen == [(0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 0, 0), (1, 0, 0)]

    sizes = [1, 2, 3, 4, 6, 7, 8]  # with 64: eight signatures
    for rows in sizes:
        s = _scenes(env, params, rows)
        _graphed(env, params, s, _actions(env, rows, gen))
    assert len(env._graphs.seen) == env._graphs.limit == 8
    ninth = _scenes(env, params, 9)
    ninth_action = _actions(env, 9, gen)
    for _ in range(3):
        out, calls = _counted(lambda: _graphed(env, params, ninth, ninth_action))
        assert calls == {"replays": 0, "captures": 0, "eager": 1}
        _assert_same_bits(out, env._transition_eager(params, ninth, ninth_action))

    # a second call of a held signature captures; its syncs are as the debug mode's
    s = _scenes(env, params, 2)
    a = _actions(env, 2, gen)
    torch.cuda.synchronize(dev)
    before = counters["host.syncs"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, calls = _counted(lambda: _graphed(env, params, s, a))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reported = sum("synchroniz" in str(w.message) for w in caught)
    counted = counters["host.syncs"] - before
    print(f"a capture: {counted} counted, {reported} reported")
    assert calls == {"replays": 0, "captures": 1, "eager": 0}
    assert counted == reported
