"""Stochastic GBOP on Sailing at ``SailingEnv/agents/gbop.json``'s settings
(budget 200: 3 episodes of horizon 55, gamma 0.99, one next-state slot)
against the benchmark's plain reference
(``perfbench/reference/gbop_stochastic.py`` over
``perfbench/reference/sailing.py``), Sailing's seeded reset and null-draw
transition, the planner's tracing, and its episode graph.

The port's ``gbop_stochastic_plan_batch`` plans from seeded boats under the
same draws as the reference: the actions and every field of the arenas are
equal, the float fields bit for bit (the same float32 operations in the
same order on one device), at widths 1 and 3. The reference's sweep is
checked on a three-node graph worked out by hand. Traced, a plan records
its spans (``planner.plan``; a step's ``gbop.descend`` holding its
``env.transition``, then ``gbop.bounds``; an episode's ``gbop.vi``; the
plan's ``gbop.root``) and counts its episodes, steps and host syncs;
tracing changes no bit. The episode graph's logic runs on the CPU with its
capture replaced by the first plan's episode body run again: plans in a
row give the eager plans' bits and counts.

The tests marked ``card`` need a CUDA card (they skip without one): on the
card, replayed episodes give the eager episodes' bits and the reference's,
and a plan's ``host.syncs`` equal the synchronisations that
``torch.cuda.set_sync_debug_mode`` reports. Run them on the card with
``python -m pytest tests/test_torch_gbop_sailing.py -m card -s``."""
import collections
import pathlib
import types
import warnings

import pytest
import torch

from perfbench.pbcore import draws as draw
from perfbench.reference import gbop_stochastic as ref_gbop
from perfbench.reference import sailing as ref_sailing
from rl_agents_torch.agents.tree_search import graph_based_stochastic as gbs
from rl_agents_torch.agents.tree_search.batch import gbop_stochastic_plan_batch
from rl_agents_torch.envs.sailing import NULL_KEY_UNIFORM, SailingState
from rl_agents_torch.factory import load_environment
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.trainer import profiling
from rl_agents_torch.trainer.profiling import counters

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "configs" / "SailingEnv"
ENV = {"id": "sailing-v0", "size": 8}
A = 8
# gbop.json's settings (perfbench/configs/gbop-sailing.json's sizes) but the split
SETTINGS = dict(num_actions=A, gamma=0.99, accuracy=1e-2, reward_threshold_coeff=1.0,
                transition_threshold_coeff=0.1, vi_sweeps=20)
FIELDS = ("visited", "value_lower", "value_upper", "n_count", "c_count", "sa_count",
          "sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "sa_keys", "sa_child", "sa_n", "used")


class _RefEnv:
    """Sailing's plain reference as the reference planner steps it (the
    benchmark's ``perfbench/envs/sailing-v0.py``)."""
    transition = staticmethod(ref_sailing.step)
    observation = staticmethod(ref_sailing.observation)
    observation_keys = staticmethod(ref_sailing.observation_keys)


def _case(trees: int, seed: int, device="cpu"):
    """The program's env, params, start states and observations, and the
    reference's model and start states, from the same seeded draw."""
    handle = load_environment(dict(ENV), device=device)
    env, params = handle.functional, handle.params
    gen = draw.generator(seed, draw.SCENES, 0, device)
    starts = (torch.randint(0, 7, (trees, 2), generator=gen, device=device),
              torch.randint(0, 8, (trees,), generator=gen, device=device))
    states0, obs0 = env.reset(params, None, trees, noise=starts)
    model = ref_sailing.model_of(ENV)
    return env, params, states0, obs0, model, ref_sailing.reset(model, starts)


def _draws(episodes: int, horizon: int, trees: int, seed: int, device="cpu"):
    gen = draw.generator(seed, draw.PLAN, 0, device)
    noise = draw.gumbel((episodes, horizon, trees, A), gen)
    final = draw.gumbel((trees, A), gen)
    return noise, final, torch.rand((episodes, horizon, trees), generator=gen, device=device)


def _program(case, drawn, episodes, horizon, width, device="cpu"):
    env, params, states0, obs0 = case[:4]
    noise, final, uniforms = drawn
    return gbop_stochastic_plan_batch(env, params, states0, obs0, None, noise=(noise, final),
                                      env_noise=uniforms, episodes=episodes, horizon=horizon,
                                      width=width, device=device, **SETTINGS)


def _reference(case, drawn, episodes, horizon, width):
    model, starts = case[4:]
    noise, final, uniforms = drawn
    return ref_gbop.plan(_RefEnv, model, starts, noise, final, uniforms, episodes=episodes,
                         horizon=horizon, width=width, **SETTINGS)


def _same(got, want, fields=FIELDS):
    for field in fields:
        assert torch.equal(getattr(got, field), getattr(want, field).to(getattr(got, field).device)), field


# (trees, episodes, horizon, width): a short split at one and three slots, the
# short split of ten episodes at which three slots fill, and gbop.json's own
@pytest.mark.parametrize("trees, episodes, horizon, width",
                         [(8, 2, 6, 1), (16, 2, 6, 3), (16, 10, 3, 3), (8, 3, 55, 1)])
def test_the_port_plans_as_the_reference(trees, episodes, horizon, width):
    seed = 2**31 + 101 * trees + episodes + width
    case = _case(trees, seed)
    drawn = _draws(episodes, horizon, trees, seed)
    action, graph = _program(case, drawn, episodes, horizon, width)
    want_action, want = _reference(case, drawn, episodes, horizon, width)
    assert torch.equal(action, want_action)
    _same(graph, want)
    assert int(graph.n_count.sum()) == trees * episodes * horizon
    # Sailing pays -cost / worst: negative sums went through the KL bounds,
    # and the bounds are informative
    visited = graph.sa_count > 0
    assert bool((graph.sa_cum_reward[visited] < 0).any())
    assert bool(((graph.sa_mu_ucb < 1) & visited).any())
    if width == 3 and episodes == 10:
        assert int(graph.sa_n.max()) == 3  # the constrained solve ran on three atoms
    # the graph merged observations: some walk came back to a node
    assert bool((graph.used < 2 + episodes * horizon).all())


def test_the_reference_sweeps_a_three_node_graph_as_worked_out_by_hand():
    """Root 0 takes action 0 twice to node 1 (reward bounds [0.25, 0.75]) and
    action 1 once to node 2 ([0, 0.5]); node 1 took action 0 once, back to
    the root ([0, 0.5]), never action 1; node 2 was never left. gamma 1/2,
    so values lie in [0, 2]. Sweeps are Jacobi sweeps from the previous
    bounds. The first: V+(0) = max(0.75 + 2/2, 0.5 + 2/2) = 1.75, V-(0) =
    max(0.25 + 0, 0 + 0) = 0.25; V+(1) = max(0.5 + 2/2, 2) = 2 (an action not
    taken), V-(1) = 0; node 2 keeps [0, 2]. The upper bounds stay there. The
    lower ones: V-(1) = V-(0) / 2 = 0.125 in the second, V-(0) = 0.25 +
    0.125 / 2 = 0.3125 in the third, which moves by 0.0625: at accuracy 0.1
    the graph stops there. Their fixed point is V-(0) = 1/3, V-(1) = 1/6."""
    N, A_, W = 3, 2, 1
    i64 = torch.int64
    t = ref_gbop.Graph(
        visited=torch.tensor([[True, True, False]]), value_lower=torch.zeros(1, N),
        value_upper=torch.full((1, N), 2.0), n_count=torch.tensor([[3, 1, 0]]),
        c_count=torch.tensor([[[2, 1], [1, 0], [0, 0]]]),
        sa_count=torch.tensor([[[[2], [1]], [[1], [0]], [[0], [0]]]]),
        sa_cum_reward=torch.zeros(1, N, A_, W),
        sa_mu_ucb=torch.tensor([[[[0.75], [0.5]], [[0.5], [1.0]], [[1.0], [1.0]]]]),
        sa_mu_lcb=torch.tensor([[[[0.25], [0.0]], [[0.0], [0.0]], [[0.0], [0.0]]]]),
        sa_keys=torch.zeros(1, N, A_, W, dtype=i64),
        sa_child=torch.tensor([[[[1], [2]], [[0], [-1]], [[-1], [-1]]]]),
        sa_n=torch.tensor([[[1, 1], [1, 0], [0, 0]]]), used=torch.tensor([3]))
    constants = (torch.tensor(0.5), torch.tensor(2.0), torch.tensor(0.1))
    lo, hi = ref_gbop.sweeps(t, *constants, accuracy=0.0, vi_sweeps=1, dtype=torch.float32)
    assert hi.tolist() == [[1.75, 2.0, 2.0]] and lo.tolist() == [[0.25, 0.0, 0.0]]
    lo, hi = ref_gbop.sweeps(t, *constants, accuracy=0.1, vi_sweeps=20, dtype=torch.float32)
    assert hi.tolist() == [[1.75, 2.0, 2.0]] and lo.tolist() == [[0.3125, 0.125, 0.0]]
    q_up, q_lo = ref_gbop.graph_q_bounds(t, hi, lo, *constants, torch.float32)
    assert q_up[0, 1].tolist() == [0.5 + 1.75 / 2, 2.0] and q_lo[0, 0].tolist() == [0.3125, 0.0]
    lo, _ = ref_gbop.sweeps(t, *constants, accuracy=0.0, vi_sweeps=40, dtype=torch.float32)
    assert torch.allclose(lo, torch.tensor([[1 / 3, 1 / 6, 0.0]]), atol=1e-6)


def test_reset_puts_each_boat_at_its_drawn_start():
    handle = load_environment(dict(ENV), device="cpu")
    env, params = handle.functional, handle.params
    pos, wind = torch.tensor([[3, 1], [0, 6], [5, 5]]), torch.tensor([7, 0, 2])
    state, obs = env.reset(params, None, 3, noise=(pos, wind))
    assert torch.equal(state.pos, pos) and torch.equal(state.wind, wind)
    assert state.t.tolist() == [0] * 3 and torch.equal(obs, env.observe(params, state))
    # without noise: every boat at the origin, winds from the generator, as before
    plain, _ = env.reset(params, torch.Generator().manual_seed(4), 3)
    drawn = env.reset_noise(params, torch.Generator().manual_seed(4), 3)
    again, _ = env.reset(params, None, 3, noise=drawn)
    assert plain.pos.tolist() == [[0, 0]] * 3
    assert torch.equal(plain.wind, again.wind) and torch.equal(plain.pos, again.pos)
    assert torch.equal(plain.wind, torch.randint(0, 8, (3,),
                                                 generator=torch.Generator().manual_seed(4)))


def test_a_transition_without_draws_takes_the_null_draw():
    """``transition`` given neither a generator nor noise turns the wind under
    ``null_noise`` (above 0.75: one step clockwise) and leaves PyTorch's
    default generator as it was; ``step`` asks for one."""
    handle = load_environment(dict(ENV), device="cpu")
    env, params = handle.functional, handle.params
    state, _ = env.reset(params, None, 16, noise=(torch.arange(32).reshape(16, 2) % 7,
                                                  torch.arange(16) % 8))
    actions = torch.arange(16) % 8
    rng = torch.get_rng_state()
    out = env.transition(params, state, actions)
    assert torch.equal(torch.get_rng_state(), rng)
    want = env.step(params, state, actions, None, torch.full((16,), NULL_KEY_UNIFORM))
    assert torch.equal(out.state.wind, want.state.wind) and torch.equal(out.reward, want.reward)
    assert torch.equal(out.state.wind, (state.wind + 1) % 8)
    with pytest.raises(ValueError, match="generator or injected noise"):
        env.step(params, state, actions)


def test_the_reference_step_and_keys_are_the_ports():
    """Every observation of the 8 x 8 grid (positions x winds) under every
    action and uniform draws: the reference's next state and reward equal
    the port's bits, and its observation keys the port's ``obs_key``."""
    handle = load_environment(dict(ENV), device="cpu")
    env, params = handle.functional, handle.params
    model = ref_sailing.model_of(ENV)
    number = torch.arange(8 * 8 * 8).repeat_interleave(A)
    state = SailingState(pos=torch.stack([number // 64, (number // 8) % 8], dim=1),
                         wind=number % 8, t=torch.zeros_like(number))
    assert torch.equal(ref_sailing.observation(model, ref_sailing.State(state.pos, state.wind)),
                       number)
    keys = ref_sailing.observation_keys(model, "cpu")
    assert torch.equal(keys[number], obs_key(env.observe(params, state)))
    actions = torch.arange(A).repeat(8 * 8 * 8)
    for seed in range(3):
        u = torch.rand(number.shape, generator=torch.Generator().manual_seed(seed))
        out = env.step(params, state, actions, None, u)
        nxt, reward = ref_sailing.step(model, ref_sailing.State(state.pos, state.wind), actions, u)
        assert torch.equal(out.state.pos, nxt.pos) and torch.equal(out.state.wind, nxt.wind)
        assert torch.equal(out.reward, reward)
    assert float(reward.max()) == 1.0 and -1.0 <= float(reward.min()) < -0.9


def _traced(episodes, horizon, trees=4, width=1):
    seed = 2**32 + 3
    case = _case(trees, seed)
    drawn = _draws(episodes, horizon, trees, seed)
    profiling.take()
    before = counters.copy()
    profiling.enable()
    try:
        out = _program(case, drawn, episodes, horizon, width)
    finally:
        profiling.disable()
    return out, profiling.take(), counters - before


def test_a_traced_plan_records_its_spans_and_counts():
    episodes, horizon = 2, 5
    _, spans, counted = _traced(episodes, horizon)
    names = [s.name for s in spans]
    step = ["gbop.descend", "env.transition", "gbop.bounds"]
    assert names == ["planner.plan"] + (step * horizon + ["gbop.vi"]) * episodes + ["gbop.root"]
    plan = spans[0]
    for s in spans[1:]:
        assert s.root == 0 and plan.start_ns <= s.start_ns <= s.end_ns <= plan.end_ns
        assert spans[s.parent].name == ("gbop.descend" if s.name == "env.transition"
                                        else "planner.plan")
    assert counted["gbop.episodes"] == episodes and counted["gbop.steps"] == episodes * horizon
    assert counted["gbop_stochastic.vi_calls"] == episodes
    assert counted["kl_bounds_pair_.launches"] == 0  # the CPU runs the plain version
    # the four host values, a read-back a sweep, and the plan's last read
    assert counted["host.syncs"] == 4 + counted["gbop_stochastic.vi_sweeps"] + 1
    assert 0 < counted["gbop_stochastic.vi_tree_sweeps"] <= 4 * counted["gbop_stochastic.vi_sweeps"]


def test_tracing_changes_no_bit():
    seed = 2**32 + 3
    quiet = _program(_case(4, seed), _draws(2, 5, 4, seed), 2, 5, 3)
    (action, graph), _, _ = _traced(2, 5, width=3)
    assert torch.equal(action, quiet[0])
    _same(graph, quiet[1])


@pytest.mark.parametrize("handed, copies", [("tensors", 0), ("draws as arrays", 2),
                                            ("env draws as an array too", 3),
                                            ("a generator", 0)])
def test_host_syncs_count_what_is_copied_onto_the_device(handed, copies):
    case = _case(2, 5)
    noise, final, uniforms = _draws(2, 3, 2, 5)
    env, params, states0, obs0 = case[:4]
    drawn, gen = (noise, final), None
    if handed != "tensors":
        drawn = (noise.numpy(), final.numpy())
    if handed == "env draws as an array too":
        uniforms = uniforms.numpy()
    if handed == "a generator":
        drawn, uniforms, gen = None, None, torch.Generator().manual_seed(0)
    before = counters.copy()
    gbop_stochastic_plan_batch(env, params, states0, obs0, gen, noise=drawn, env_noise=uniforms,
                               episodes=2, horizon=3, width=1, device="cpu", **SETTINGS)
    counted = counters - before
    assert counted["host.syncs"] - counted["gbop_stochastic.vi_sweeps"] == 4 + 1 + copies


def _emulated_capture(graph, run_episode):
    """The episode graph's capture on the CPU: it keeps the episode body of
    the plan that captures and runs it again at each replay, as a CUDA graph
    replays what it recorded. A body that held a buffer of its own plan, not
    a static one, would read that plan's values in later plans."""
    def run():
        """The body, its counts left out: a replay's are ``counted``'s."""
        before = counters.copy()
        run_episode(graph.g, graph.env_draws, captured=True)
        counted = counters - before
        counters.subtract(counted)
        return counted

    graph.counted = run()
    counters["gbop.episode_graph.captures"] += 1
    graph._clear()
    graph.cuda_graph = types.SimpleNamespace(replay=run)


def _replayed_plans(monkeypatch, plans, width, device="cpu"):
    """(graph path, eager path) outputs and counter increases of ``plans``,
    each ``(trees, seed, episodes, horizon)``, one env for all."""
    monkeypatch.setattr(gbs, "_graphs", type(gbs._graphs)())
    outs = {}
    for path in ("graph", "eager"):
        with monkeypatch.context() as m:
            if path == "eager":
                m.setattr(gbs, "episode_graph_declines", lambda *args: "eager by the test")
            elif device == "cpu":
                m.setattr(gbs, "episode_graph_declines", lambda *args: None)
                m.setattr(gbs._EpisodeGraph, "_capture", _emulated_capture)
            env = params = None
            results, counted = [], collections.Counter()
            for trees, seed, episodes, horizon in plans:
                case = _case(trees, seed, device)
                if env is None:  # one env for every plan, as a benchmark run holds it
                    env, params = case[:2]
                case = (env, params) + case[2:]
                drawn = _draws(episodes, horizon, trees, seed, device)
                before = counters.copy()
                results.append(_program(case, drawn, episodes, horizon, width, device))
                counted += counters - before
            outs[path] = (results, counted)
    return outs


@pytest.mark.parametrize("width", [1, 3])
def test_the_episode_graphs_logic_gives_the_eager_bits(monkeypatch, width):
    plans = [(8, 2**31 + 7, 2, 6), (8, 2**33 + 1, 2, 6), (8, 2**31 + 9, 1, 6)]
    outs = _replayed_plans(monkeypatch, plans, width)
    (graph_runs, graph_count), (eager_runs, eager_count) = outs["graph"], outs["eager"]
    for (action, graph), (want_action, want) in zip(graph_runs, eager_runs):
        assert torch.equal(action, want_action)
        _same(graph, want)
        for got, exp in zip(graph.table, want.table):
            assert torch.equal(got, exp)
    # the first plan's output is a copy: later plans left it alone
    assert graph_runs[0][1].visited.data_ptr() != graph_runs[1][1].visited.data_ptr()
    # one capture a signature (2 x 6, then 1 x 6), one replay an episode
    assert graph_count["gbop.episode_graph.captures"] == 2
    assert graph_count["gbop.episode_graph.replays"] == 2 + 2 + 1
    assert eager_count["gbop.episode_graph.replays"] == 0
    for name in ("gbop.episodes", "gbop.steps", "gbop_stochastic.vi_calls",
                 "gbop_stochastic.vi_tree_sweeps", "kl_bounds_pair_.launches"):
        assert graph_count[name] == eager_count[name], name
    # every sweep runs in a replayed episode, none is read back: a plan's
    # syncs are its four host values and its last read, beside the CPU's
    # Newton read-backs at width 3 (one a block of 8 trips, more in the
    # replayed episodes' extra sweeps; on a card the solve is a kernel launch)
    newton = {path: count["newton_iteration.trips"] // 8 for path, count in
              (("graph", graph_count), ("eager", eager_count))}
    assert (newton["graph"] > 0) == (newton["eager"] > 0) == (width > 1)
    assert graph_count["gbop_stochastic.vi_sweeps"] == 20 * 5
    assert graph_count["host.syncs"] - newton["graph"] == 5 * 3
    assert eager_count["host.syncs"] - newton["eager"] \
        == 5 * 3 + eager_count["gbop_stochastic.vi_sweeps"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_on_the_card_replayed_episodes_give_the_eager_bits_and_the_references(monkeypatch):
    """Plans in a row on the card at ``gbop.json``'s split (64 graphs from
    other boats and draws, then a plan cut to 1 episode): the replayed
    episodes give the eager episodes' bits and counts, and the reference's;
    each signature is captured once and each episode replayed."""
    dev = _card()
    plans = [(64, 2**32 + 17, 3, 55), (64, 2**33 + 5, 3, 55), (64, 2**31 + 9, 1, 55)]
    outs = _replayed_plans(monkeypatch, plans, 1, dev)
    (graph_runs, graph_count), (eager_runs, eager_count) = outs["graph"], outs["eager"]
    for (trees, seed, episodes, horizon), (action, graph), (want_action, want) in zip(
            plans, graph_runs, eager_runs):
        assert torch.equal(action, want_action)
        _same(graph, want)
        ref_action, ref = _reference(_case(trees, seed, dev),
                                     _draws(episodes, horizon, trees, seed, dev), episodes,
                                     horizon, 1)
        assert torch.equal(action, ref_action)
        _same(graph, ref)
    assert graph_count["gbop.episode_graph.captures"] == 2
    assert graph_count["gbop.episode_graph.replays"] == 3 + 3 + 1
    for name in ("gbop.steps", "gbop_stochastic.vi_tree_sweeps", "kl_bounds_pair_.launches"):
        assert graph_count[name] == eager_count[name], name
    assert graph_count["kl_bounds_pair_.launches"] == 55 * 7
    assert graph_count["host.syncs"] == 5 * 3


@pytest.mark.card
@pytest.mark.parametrize("path", ["graph", "eager"])
def test_host_syncs_equal_the_synchronisations_cuda_reports(monkeypatch, path):
    """One plan of the benchmark's cell (4096 graphs, 3 x 55), replayed (its
    episodes captured by a plan before) or eager: ``host.syncs`` rises by the
    number of synchronising operations ``set_sync_debug_mode("warn")``
    reports."""
    dev = _card()
    if path == "eager":
        monkeypatch.setattr(gbs, "episode_graph_declines", lambda *args: "eager by the test")
    case = _case(4096, 2**31 + 1, dev)
    drawn = _draws(3, 55, 4096, 2**31 + 1, dev)
    run = lambda: _program(case, drawn, 3, 55, 1, dev)
    run()  # the KL library's first load, and the capture
    torch.cuda.synchronize(dev)
    before = counters["host.syncs"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reported = sum("synchroniz" in str(w.message) for w in caught)
    counted = counters["host.syncs"] - before
    print(f"stochastic GBOP batch plan, {path}: {counted} counted, {reported} reported")
    assert counted == reported > 0
