"""KL-OLOP's episodes replayed as CUDA graphs (``olop.py::_EpisodeGraph``
over ``agents/tree_search/episode_graph.py``) against its eager episodes, on
highway at ``OLOPAgent/kl-olop.json``'s settings (budget 500: 72 episodes of
horizon 6, gamma 0.7, threshold 2 log(time)).

On the CPU every episode runs eagerly, and the plan hands
``episode_graph_declines`` its continuation actions and inputs, so that the
rule names why for each form of call. The episode graph's logic runs on the
CPU with its capture replaced by a host stand-in that keeps the captured
episode's body and runs it again at each replay, as a CUDA graph replays
what it recorded: plans in a row, the shorter ones sharing the capture, give
the eager plans' bits, and a plan's outputs outlive later plans.

The tests marked ``card`` need a CUDA card (they skip without one): replayed
episodes give the eager episodes' bits and counts under both bounds and both
times, plans of 6 and 3 episodes share a 72-episode plan's capture, an
agent captures once over its acts, and a plan's ``host.syncs`` equal the
synchronisations that ``torch.cuda.set_sync_debug_mode`` reports. Run them
on the card with ``python -m pytest tests/test_torch_olop_graph.py -m card
-s``."""
import time
import warnings

import pytest
import torch

from rl_agents_torch.agents.tree_search import episode_graph
from rl_agents_torch.agents.tree_search import olop
from rl_agents_torch.agents.tree_search.episode_graph import Kept
from rl_agents_torch.agents.tree_search.mcts_fused import episode_graph_declines
from rl_agents_torch.envs.base import EnvSpec
from rl_agents_torch.envs.minigrid import MiniGridState
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.trainer.profiling import counters

torch.set_num_threads(1)

# the benchmark's highway scene and KL-OLOP agent (perfbench/configs/kl-olop-highway.json)
HIGHWAY = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
A, H, GAMMA = 5, 6, 0.7
EPISODE_COUNTERS = ("olop.episode_eager.calls", "olop.episode_graph.replays",
                    "olop.episode_graph.captures")
BOUNDS = [("kullback-leibler", True), ("kullback-leibler", False), ("hoeffding", True),
          ("hoeffding", False)]


def _case(trees: int, seed: int, device="cpu"):
    """The program's env and params, and ``trees`` start states drawn from a
    seeded host generator."""
    handle = load_environment(dict(HIGHWAY), device=device)
    env, params = handle.functional, handle.params
    return env, params, _scenes(env, trees, seed, device)


def _scenes(env, trees: int, seed: int, device):
    cpu = env.default_params("cpu")
    states0, _ = env.reset(cpu, torch.Generator().manual_seed(seed), trees)
    return type(states0)(*(x.to(device) for x in states0))


def _continuation(episodes: int, trees: int, seed: int, device="cpu"):
    return torch.randint(0, A, (episodes, H, trees),
                         generator=torch.Generator().manual_seed(seed)).to(device)


def _plan(env, params, states0, continuation, episodes, ucb_type="kullback-leibler",
          time_global=True, device="cpu"):
    return olop.olop_plan(env, params, states0, None, num_actions=A, episodes=episodes,
                          horizon=H, gamma=GAMMA, threshold_coeff=2.0, ucb_type=ucb_type,
                          time_global=time_global, continuation_uniform=True,
                          random_actions=continuation[:episodes], device=device)


def _episodes_counted(counted) -> tuple:
    """(eager episodes, replayed episodes, captures) in a counters' increase."""
    return tuple(counted.get(name, 0) for name in EPISODE_COUNTERS)


def _assert_same_plan(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for field in got[2]._fields:
        assert torch.equal(getattr(got[2], field), getattr(want[2], field)), field


def _copy(plan):
    actions, lengths, tree = plan
    return actions.clone(), lengths.clone(), type(tree)(*(x.clone() for x in tree))


class _Unmarked:
    """The program's env without the mark that its transition draws nothing:
    the plan runs its episodes eagerly on any device."""

    def __init__(self, env):
        self.env = env

    def transition(self, *args):
        return self.env.transition(*args)


@pytest.mark.parametrize("form", ["injected continuation", "a generator", "grad into an input"])
def test_on_the_cpu_every_episode_runs_eagerly(form):
    episodes = 3
    env, params, states0 = _case(2, 17)
    continuation, generator = _continuation(episodes, 2, 17), None
    if form == "a generator":
        continuation, generator = None, torch.Generator().manual_seed(0)
    if form == "grad into an input":
        states0 = states0._replace(speed=states0.speed.clone().requires_grad_())
    before = counters.copy()
    olop.olop_plan(env, params, states0, generator, num_actions=A, episodes=episodes,
                   horizon=H, gamma=GAMMA, threshold_coeff=2.0, continuation_uniform=True,
                   random_actions=continuation, device="cpu")
    assert _episodes_counted(counters - before) == (episodes, 0, 0)


@pytest.mark.parametrize("form, reason", [
    ("the highway env, its continuation drawn up front", None),
    ("an env that may draw", "the env draws from a generator"),
    ("grad into an input", "grad into an input"),
    ("a caller's capture", "inside a capture"),
])
def test_the_plan_asks_the_rule_with_its_draws_and_inputs(monkeypatch, form, reason):
    """What the plan hands the rule, judged as on a card: the continuation
    actions are the episode's draws, drawn before the first episode even
    where a generator draws them, and the params and states are its inputs.
    On the CPU the rule declines, and the episodes run eagerly."""
    asked = []

    def spy(env, device, noise, env_noise, inputs):
        asked.append((env, noise, env_noise, inputs))
        return episode_graph_declines(env, device, noise, env_noise, inputs)

    monkeypatch.setattr(olop, "episode_graph_declines", spy)
    env, params, states0 = _case(2, 19)
    if form == "an env that may draw":
        env = _Unmarked(env)
    if form == "grad into an input":
        states0 = states0._replace(speed=states0.speed.clone().requires_grad_())
    before = counters.copy()
    olop.olop_plan(env, params, states0, torch.Generator().manual_seed(1), num_actions=A,
                   episodes=3, horizon=H, gamma=GAMMA, threshold_coeff=2.0,
                   continuation_uniform=True, device="cpu")
    assert _episodes_counted(counters - before) == (3, 0, 0)
    ((env_asked, noise, env_noise, inputs),) = asked
    assert env_asked is env and env_noise is None
    assert noise.shape == (3, H, 2) and noise.dtype == torch.int64
    capturing = form == "a caller's capture"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    assert episode_graph_declines(env_asked, torch.device("cuda"), noise, env_noise,
                                  inputs) == reason


def _emulated_capture(run, device):
    """The capture on the CPU: it keeps the body of the episode that
    captures and runs it again at each replay, as a CUDA graph replays what
    it recorded; its counts left out, since a replay adds ``counted``. A body
    that held a buffer of its own plan, not a static one, would read that
    plan's values in later plans."""
    def body():
        before = counters.copy()
        run()
        counted = counters - before
        counters.subtract(counted)
        return counted

    return body, body()


@pytest.fixture
def emulated(monkeypatch):
    """Every plan takes the graph path, its capture emulated; no capture
    kept from another test."""
    monkeypatch.setattr(olop, "_kept", Kept(4))
    monkeypatch.setattr(episode_graph, "capture", _emulated_capture)
    monkeypatch.setattr(olop, "episode_graph_declines", lambda *args: None)


def _eager(env, *args, **kwargs):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(olop, "episode_graph_declines", lambda *a: "eager by the test")
        return _plan(env, *args, **kwargs)


@pytest.mark.parametrize("ucb_type, time_global", BOUNDS)
def test_the_episode_graphs_logic_gives_the_eager_bits(emulated, ucb_type, time_global):
    """Plans of 4, then 2 and 3 episodes of new start states and draws: one
    capture in the first, shared by the shorter ones, the eager bits in all,
    and the first plan's outputs unchanged by the later ones."""
    trees = 4
    env, params, _ = _case(trees, 1)
    before = counters.copy()
    plans = []
    for call, episodes in enumerate((4, 2, 3)):
        states0 = _scenes(env, trees, 2**31 + call, "cpu")
        continuation = _continuation(episodes, trees, 2**32 + call)
        got = _plan(env, params, states0, continuation, episodes, ucb_type, time_global)
        _assert_same_plan(got, _eager(env, params, states0, continuation, episodes, ucb_type,
                                      time_global))
        assert got[2].parent.shape == (trees, 1 + episodes * H * A)
        plans.append((got, _copy(got)))
    counted = counters - before
    assert _episodes_counted(counted) == (9, 9, 1)
    for got, kept in plans:
        _assert_same_plan(got, kept)


def test_a_plan_of_more_episodes_than_the_kept_capture_captures_again(emulated):
    trees = 2
    env, params, states0 = _case(trees, 3)
    continuation = _continuation(4, trees, 3)
    before = counters.copy()
    for episodes in (2, 4, 3):
        got = _plan(env, params, states0, continuation, episodes)
        _assert_same_plan(got, _eager(env, params, states0, continuation, episodes))
    assert _episodes_counted(counters - before) == (9, 9, 2)


def test_each_bound_and_env_has_its_capture(emulated):
    """A capture for each bound and each env configuration; an env made anew
    with the same configuration shares its capture."""
    trees = 2
    env, params, states0 = _case(trees, 5)
    same, _, _ = _case(trees, 5)
    other = load_environment(dict(HIGHWAY, duration=30), device="cpu").functional
    continuation = _continuation(2, trees, 5)
    before = counters.copy()
    for planned_env, ucb_type in ((env, "kullback-leibler"), (env, "hoeffding"),
                                  (other, "kullback-leibler"), (same, "kullback-leibler"),
                                  (env, "kullback-leibler")):
        _plan(planned_env, params, states0, continuation, 2, ucb_type)
    assert _episodes_counted(counters - before) == (0, 10, 3)


class _Configured:
    def __init__(self, **attributes):
        self.__dict__.update(attributes)


@pytest.mark.parametrize("first, second, shared", [
    ({"size": 16, "task": "empty", "spec": EnvSpec("minigrid-empty", 100)},
     {"size": 16, "task": "empty", "spec": EnvSpec("minigrid-empty", 100)}, True),
    ({"size": 16, "cells": (1, 2)}, {"size": 16, "cells": (1, 2)}, True),
    ({"size": 16}, {"size": 17}, False),
    ({"size": 1}, {"size": 1.0}, False),
    ({"size": 1}, {"size": True}, False),
    ({"size": 16, "cells": [1, 2]}, {"size": 16, "cells": [1, 2]}, False),
    ({"size": 16, "table": torch.zeros(2)}, {"size": 16, "table": torch.zeros(2)}, False),
])
def test_envs_of_one_configuration_share_a_key(first, second, shared):
    """Two envs of one class with equal plain attributes of equal types give
    one key; an attribute that cannot be hashed, or a tensor, keys each by
    its identity."""
    first, second = _Configured(**first), _Configured(**second)
    assert (episode_graph.env_key(first) == episode_graph.env_key(second)) == shared
    assert episode_graph.env_key(first) == episode_graph.env_key(first)


def _agent(device, preprocessors, budget):
    """An ``OLOPAgent`` at ``kl-olop.json``'s gamma and bound on the
    benchmark's highway scene, its env handle held across acts."""
    handle = load_environment(dict(HIGHWAY), device=device)
    agent = load_agent({"__class__": "OLOPAgent", "budget": budget, "gamma": GAMMA,
                        "env_preprocessors": preprocessors,
                        "upper_bound": {"type": "kullback-leibler",
                                        "threshold": "2*np.log(time)"},
                        "continuation_type": "uniform"}, handle, device=device)
    agent.seed(0)
    return handle, agent


def _acts(handle, agent, acts: int) -> list:
    actions = []
    for _ in range(acts):
        actions.append(agent.act(handle.obs[0].cpu().numpy()))
        handle.step(actions[-1])
    return actions


@pytest.mark.parametrize("preprocessors", [[], [{"method": "simplify"}]],
                         ids=["its own env", "simplify"])
def test_an_agent_captures_once_over_its_acts(emulated, preprocessors):
    """Three acts of an agent, whose ``simplify`` makes a new env each act:
    one capture, every episode replayed, the eager agent's actions."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(olop, "episode_graph_declines", lambda *a: "eager by the test")
        want = _acts(*_agent("cpu", preprocessors, 40), 3)
    handle, agent = _agent("cpu", preprocessors, 40)
    before = counters.copy()
    assert _acts(handle, agent, 3) == want
    episodes = agent.config["episodes"]
    assert _episodes_counted(counters - before) == (0, 3 * episodes, 1)


def _minigrid_case(trees: int, episodes: int, seed: int, device="cpu"):
    """``MiniGrid-Empty-16x16-v0`` at ``GridWorld/agents/kl-olop.json``'s
    horizon 9, ``trees`` start cells and headings, and the plan's injected
    draws: the continuation actions and the env's drop uniforms."""
    handle = load_environment({"id": "MiniGrid-Empty-16x16-v0"}, device=device)
    env = handle.functional
    g = torch.Generator().manual_seed(seed)
    states0 = MiniGridState(torch.randint(1, env.size - 1, (trees, 2), generator=g),
                            torch.randint(0, 4, (trees,), generator=g),
                            torch.zeros((trees, 1), dtype=torch.bool),
                            torch.zeros(trees, dtype=torch.int64))
    draws = dict(random_actions=torch.randint(0, 3, (episodes, 9, trees), generator=g),
                 env_noise=torch.rand((episodes, 9, trees), generator=g))
    to = lambda x: x.to(device)
    return (env, handle.params, type(states0)(*map(to, states0)),
            {k: to(v) for k, v in draws.items()})


def _minigrid_plan(env, params, states0, draws, episodes, device="cpu"):
    return olop.olop_plan(env, params, states0, None, num_actions=3, episodes=episodes,
                          horizon=9, gamma=0.8, threshold_coeff=4.0, continuation_uniform=True,
                          device=device, **{k: v[:episodes] for k, v in draws.items()})


def test_a_minigrid_plan_with_its_drops_handed_in_gives_the_eager_bits(emulated):
    """MiniGrid draws in its step, so a plan replays only where its drop
    uniforms are handed in: the env noise enters through a static buffer."""
    env, params, states0, draws = _minigrid_case(4, 5, 23)
    before = counters.copy()
    for episodes in (5, 3):
        got = _minigrid_plan(env, params, states0, draws, episodes)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(olop, "episode_graph_declines", lambda *a: "eager by the test")
            want = _minigrid_plan(env, params, states0, draws, episodes)
        _assert_same_plan(got, want)
    assert _episodes_counted(counters - before) == (8, 8, 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def kept(monkeypatch):
    """No capture kept from another test."""
    monkeypatch.setattr(olop, "_kept", Kept(4))


COUNTED = ("kl_bound_indexed_.launches", "env.transition_kernel.launches",
           "env.transition_eager.calls", "host.syncs")


def _counted_plan(env, params, states0, continuation, episodes, ucb_type, time_global, device):
    before = counters.copy()
    started = time.perf_counter()
    out = _plan(env, params, states0, continuation, episodes, ucb_type, time_global, device)
    torch.cuda.synchronize(device)
    return out, counters - before, time.perf_counter() - started


@pytest.mark.card
@pytest.mark.parametrize("ucb_type, time_global", BOUNDS)
def test_on_the_card_replayed_episodes_give_the_eager_bits_and_counts(kept, ucb_type,
                                                                      time_global):
    """Two plans of 256 trees x 72 x 6 of new start states and draws: the
    graph's (captured in the first) against the same plans' eager episodes,
    an env without the mark that its transition draws nothing."""
    dev = _card()
    trees, episodes = 256, 72
    env, params, _ = _case(trees, 7, dev)
    kl = ucb_type == "kullback-leibler"
    for call in range(2):
        seed = 2**33 + 10 * call
        states0 = _scenes(env, trees, seed, dev)
        continuation = _continuation(episodes, trees, seed, dev)
        got, counted, graph_s = _counted_plan(env, params, states0, continuation, episodes,
                                              ucb_type, time_global, dev)
        want, eager, eager_s = _counted_plan(_Unmarked(env), params, states0, continuation,
                                             episodes, ucb_type, time_global, dev)
        print(f"B={trees} E={episodes} H={H} {ucb_type} time_global={time_global} "
              f"call {call}: graph {graph_s * 1e3!r} ms, eager {eager_s * 1e3!r} ms")
        _assert_same_plan(got, want)
        assert _episodes_counted(counted) == (0, episodes, call == 0)
        assert _episodes_counted(eager) == (episodes, 0, 0)
        assert counted["kl_bound_indexed_.launches"] == (episodes if kl else 0)
        assert counted["env.transition_kernel.launches"] == episodes * H
        assert counted["env.transition_eager.calls"] == 0
        # both paths copy the B-value table and gamma from the host, and no more
        assert counted["host.syncs"] == eager["host.syncs"] == 2
        assert [counted[k] for k in COUNTED[:3]] == [eager[k] for k in COUNTED[:3]]


@pytest.mark.card
def test_on_the_card_plans_of_fewer_episodes_share_the_capture(kept):
    """72, 6 and 3 episodes, as the cell's warm-up and its traced segments
    plan: one capture, one replay an episode, the eager bits."""
    dev = _card()
    trees = 256
    env, params, states0 = _case(trees, 11, dev)
    continuation = _continuation(72, trees, 11, dev)
    before = counters.copy()
    for episodes in (72, 6, 3):
        got = _plan(env, params, states0, continuation, episodes, device=dev)
        want = _plan(_Unmarked(env), params, states0, continuation, episodes, device=dev)
        _assert_same_plan(got, want)
    assert _episodes_counted(counters - before) == (81, 81, 1)


@pytest.mark.card
def test_on_the_card_a_plan_keeps_its_outputs_after_later_plans(kept):
    dev = _card()
    trees = 64
    env, params, states0 = _case(trees, 13, dev)
    first = _plan(env, params, states0, _continuation(72, trees, 13, dev), 72, device=dev)
    kept_first = _copy(first)
    for seed in (14, 15):
        _plan(env, params, _scenes(env, trees, seed, dev), _continuation(72, trees, seed, dev),
              72, device=dev)
    torch.cuda.synchronize(dev)
    _assert_same_plan(first, kept_first)


@pytest.mark.card
def test_on_the_card_an_agent_captures_once_over_its_acts(kept):
    """An ``OLOPAgent`` at ``kl-olop.json``'s budget, gamma and bound on
    highway (its env handle held across acts): three acts, one capture, every
    episode replayed, one KL launch an episode."""
    dev = _card()
    handle, agent = _agent(dev, [], 500)
    episodes = agent.config["episodes"]
    before = counters.copy()
    _acts(handle, agent, 3)
    torch.cuda.synchronize(dev)
    counted = counters - before
    assert _episodes_counted(counted) == (0, 3 * episodes, 1)
    assert counted["kl_bound_indexed_.launches"] == 3 * episodes


@pytest.mark.card
def test_on_the_card_a_simplifying_agent_captures_once_and_acts_as_the_eager_one(kept):
    """``kl-olop.json`` itself, whose ``simplify`` makes a new env each act:
    three acts, one capture, the eager agent's actions; each act's time
    printed for both."""
    dev = _card()
    simplify = [{"method": "simplify"}]
    timed = {}
    for path in ("eager", "graph"):
        handle, agent = _agent(dev, simplify, 500)
        with pytest.MonkeyPatch.context() as m:
            if path == "eager":
                m.setattr(olop, "episode_graph_declines", lambda *a: "eager by the test")
            before = counters.copy()
            acts = []
            for _ in range(4):
                started = time.perf_counter()
                acts.append(_acts(handle, agent, 1)[0])
                torch.cuda.synchronize(dev)
                timed.setdefault(path, []).append((time.perf_counter() - started) * 1e3)
        timed[path + " counted"] = _episodes_counted(counters - before)
        timed[path + " actions"] = acts
    print(f"kl-olop.json (simplify) act ms, eager {timed['eager']!r}, graph {timed['graph']!r}")
    episodes = agent.config["episodes"]
    assert timed["graph actions"] == timed["eager actions"]
    assert timed["eager counted"] == (4 * episodes, 0, 0)
    assert timed["graph counted"] == (0, 4 * episodes, 1)


@pytest.mark.card
def test_on_the_card_a_minigrid_plan_replays_with_the_eager_bits(kept):
    """MiniGrid at ``GridWorld/agents/kl-olop.json``'s 55 x 9 on 256 trees,
    its drop uniforms handed in: every episode replayed (the step copies
    nothing from the host), the eager episodes' bits, then a 5-episode plan
    on the same capture."""
    dev = _card()
    env, params, states0, draws = _minigrid_case(256, 55, 29, dev)
    before = counters.copy()
    for episodes in (55, 5):
        got = _minigrid_plan(env, params, states0, draws, episodes, dev)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(olop, "episode_graph_declines", lambda *a: "eager by the test")
            want = _minigrid_plan(env, params, states0, draws, episodes, dev)
        _assert_same_plan(got, want)
    counted = counters - before
    assert _episodes_counted(counted) == (60, 60, 1)
    assert counted["kl_bound_indexed_.launches"] == 120


@pytest.mark.card
def test_host_syncs_equal_the_synchronisations_cuda_reports(kept):
    """One replayed plan of the benchmark's cell (4096 trees, 72 x 6):
    ``host.syncs`` rises by the number of synchronising operations
    ``set_sync_debug_mode("warn")`` reports."""
    dev = _card()
    trees = 4096
    env, params, states0 = _case(trees, 2**31 + 1, dev)
    continuation = _continuation(72, trees, 2**31 + 1, dev)
    run = lambda: _plan(env, params, states0, continuation, 72, device=dev)
    run()  # the kernels' first calls and the capture
    torch.cuda.synchronize(dev)
    before = counters.copy()
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
    counted = counters - before
    print(f"KL-OLOP batch plan: {counted['host.syncs']} counted, {reported} reported")
    assert _episodes_counted(counted) == (0, 72, 0)
    assert counted["host.syncs"] == reported > 0

