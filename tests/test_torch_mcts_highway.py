"""The fused MCTS planner on highway at ``MCTSAgent.json``'s settings (budget
200: 15 episodes of horizon 13, gamma 0.9) against the benchmark's plain
reference (``perfbench/reference/mcts.py``), and its tracing.

The port's ``mcts_plan_batch`` plans seeded highway scenes under the same
Gumbel draws as the reference: every field of the plan and the tree must be
equal, the values bit for bit. The reference is checked on a tree worked out
by hand. Traced, a plan records its spans (``planner.plan``; each step's
``mcts.select``, ``env.transition`` and ``mcts.advance``; ``mcts.backup`` an
episode; ``mcts.extract``) and counts its steps and its copies from the
host; tracing changes no bit.

On the CPU every episode runs eagerly, and ``episode_graph_declines`` names
why for each form of call. The tests marked ``card`` need a CUDA card (they
skip without one): the plan's ``host.syncs`` equal the synchronisations that
``torch.cuda.set_sync_debug_mode`` reports; replayed episodes give the eager
episodes' bits and counts, keep no output of the caller's, and share one
capture among plans of fewer episodes; inside a caller's own capture the
planner takes no graph of its own. Run them on the card with
``python -m pytest tests/test_torch_mcts_highway.py -m card -s``."""
import time
import warnings
from typing import NamedTuple

import numpy as np
import pytest
import torch

from perfbench.envs import highway as ref_env
from perfbench.pbcore import draws as draw
from perfbench.reference import mcts as ref_mcts
from rl_agents_torch.agents.tree_search.batch import mcts_plan_batch
from rl_agents_torch.agents.tree_search.mcts_fused import episode_graph_declines
from rl_agents_torch.envs import cartpole, highway
from rl_agents_torch.factory import load_environment
from rl_agents_torch.trainer import profiling
from rl_agents_torch.trainer.profiling import counters

torch.set_num_threads(1)

# the benchmark's highway scene and MCTS agent (perfbench/configs/mcts-highway.json)
HIGHWAY = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
A = 5
TEMPERATURE = 20.0  # 2 / (1 - 0.9)
FIELDS = ("parent", "children", "count", "value", "used")


def _case(trees: int, seed: int, device="cpu"):
    """The program's env, params and scenes, and the reference's scenes, from
    the same seeded draws."""
    handle = load_environment(dict(HIGHWAY), device=device)
    env, params = handle.functional, handle.params
    model = ref_env.model(HIGHWAY)
    drawn = ref_env.scene_draws(draw.generator(seed, draw.SCENES, 0, device), trees, model)
    states0, _ = env.reset(params, None, trees, noise=drawn)
    return env, params, states0, model, ref_env.reset(model, drawn)


def _scenes(env, params, trees: int, seed: int, device):
    """Other seeded start states for the same env and params."""
    drawn = ref_env.scene_draws(draw.generator(seed, draw.SCENES, 0, device), trees,
                                ref_env.model(HIGHWAY))
    return env.reset(params, None, trees, noise=drawn)[0]


def _noise(episodes: int, horizon: int, trees: int, seed: int, device="cpu"):
    return draw.gumbel((episodes, horizon, 2, A, trees),
                       draw.generator(seed, draw.PLAN, 0, device))


def _probs(device="cpu"):
    return torch.full((A,), 1.0 / A, device=device)


def _program(env, params, states0, noise, episodes, horizon, gamma, device="cpu"):
    return mcts_plan_batch(env, params, states0, None, _probs(device), _probs(device),
                           num_actions=A, episodes=episodes, horizon=horizon, gamma=gamma,
                           temperature=TEMPERATURE, noise=noise, device=device)


class _Terminations:
    """The program's env, noting whether any transition ended a live scene."""

    def __init__(self, env):
        self.env, self.seen = env, False

    def transition(self, params, state, *args):
        out = self.env.transition(params, state, *args)
        self.seen |= bool((out.terminated & ~state.crashed).any())
        return out


@pytest.mark.parametrize("gamma", [0.9, 0.7])
@pytest.mark.parametrize("trees, episodes, horizon", [(8, 15, 13), (1, 15, 13), (8, 4, 3)])
def test_the_port_plans_as_the_reference(trees, episodes, horizon, gamma):
    seed = 2**31 + 101 * trees + episodes
    env, params, states0, model, scenes = _case(trees, seed)
    noise = _noise(episodes, horizon, trees, seed)
    watched = _Terminations(env)
    actions, lengths, tree = _program(watched, params, states0, noise, episodes, horizon, gamma)
    want_actions, want_lengths, want = ref_mcts.plan(
        ref_env, model, scenes, noise, _probs(), _probs(), num_actions=A, episodes=episodes,
        horizon=horizon, gamma=gamma, temperature=TEMPERATURE)
    assert torch.equal(actions, want_actions) and torch.equal(lengths, want_lengths)
    for field in FIELDS:
        assert torch.equal(getattr(tree, field), getattr(want, field)), field
    assert int(tree.count[:, 0].min()) == episodes  # every episode backs up through the root
    assert int(lengths.min()) >= 1
    if (trees, episodes, horizon) == (8, 15, 13):
        assert watched.seen  # some rollouts crash: the terminal masking is compared too


class _Chain(NamedTuple):
    t: torch.Tensor  # [B] steps taken


class _TwoArms:
    """A scene that action 1 rewards with 1 and action 0 with 0; no end."""

    @staticmethod
    def transition(model, scene, action, dtype=torch.float32):
        return _Chain(scene.t + 1), action.to(dtype), torch.zeros_like(action, dtype=torch.bool)


def test_the_reference_on_a_tree_worked_out_by_hand():
    # E = 3 episodes of horizon 2, gamma 0.5, temperature 2, prior 1/2
    draws = torch.zeros((3, 2, 2, 2, 1))
    draws[0, 0, 1, 1] = 1.0  # episode 0 rolls out from the root: action 1 (r = 1), then
    draws[0, 1, 1, 0] = 1.0  # action 0 (r = 0): return 1
    draws[1, 0, 0, 0] = 1.0  # episode 1: both children score 2; the tie goes to action 0 (r = 0)
    draws[1, 1, 1, 1] = 1.0  # node 1 expands; its rollout takes action 1: return 0.5
    draws[2, 0, 0, 0] = 1.0  # episode 2: 0.5 + 2/2 = 1.5 < 0 + 2/1, action 1 (r = 1) by score
    draws[2, 1, 1, 1] = 1.0  # node 2 expands; its rollout takes action 1: return 1.5
    probs = torch.full((2,), 0.5)
    root = _Chain(torch.zeros(1, dtype=torch.int64))
    actions, lengths, tree = ref_mcts.plan(_TwoArms, None, root, draws, probs, probs,
                                           num_actions=2, episodes=3, horizon=2, gamma=0.5,
                                           temperature=2.0)
    assert tree.parent.tolist() == [[-1, 0, 0, 1, 1, 2, 2]]
    assert tree.children[0, :3].tolist() == [[1, 2], [3, 4], [5, 6]]
    assert (tree.children[0, 3:] == -1).all()
    assert tree.count.tolist() == [[3, 1, 1, 0, 0, 0, 0]]
    # the root's mean: 1, then (1 + 0.5) / 2, then (1 + 0.5 + 1.5) / 3
    assert tree.value.tolist() == [[1.0, 0.5, 1.5, 0.0, 0.0, 0.0, 0.0]]
    assert tree.used.tolist() == [7]
    # counts tie at the root (1, 1): the larger value, action 1; then counts and
    # values tie (0, 0): the first action
    assert actions.tolist() == [[1, 0]] and lengths.tolist() == [2]


def _traced_plan(episodes, horizon, trees=4):
    seed = 2**32 + 3
    env, params, states0, _, _ = _case(trees, seed)
    noise = _noise(episodes, horizon, trees, seed)
    profiling.take()
    before = counters.copy()
    profiling.enable()
    try:
        out = _program(env, params, states0, noise, episodes, horizon, 0.9)
    finally:
        profiling.disable()
    return out, profiling.take(), counters - before


@pytest.mark.parametrize("episodes, horizon", [(15, 13), (3, 2)])
def test_a_traced_plan_records_its_spans_and_counts_its_steps(episodes, horizon):
    _, spans, counted = _traced_plan(episodes, horizon)
    names = [s.name for s in spans]
    steps = episodes * horizon
    assert names[0] == "planner.plan" and names[-1] == "mcts.extract"
    assert {name: names.count(name) for name in set(names)} == {
        "planner.plan": 1, "env.transition": steps, "mcts.select": steps, "mcts.advance": steps,
        "mcts.backup": episodes, "mcts.extract": 1}
    # each step is select, transition, advance; each episode's steps end in its backup
    step = ["mcts.select", "env.transition", "mcts.advance"]
    assert names[1:-1] == (step * horizon + ["mcts.backup"]) * episodes
    plan = spans[0]
    for s in spans[1:]:
        assert s.parent == 0 and s.root == 0
        assert plan.start_ns <= s.start_ns <= s.end_ns <= plan.end_ns
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    assert counted["mcts.steps"] == steps
    assert counted["host.syncs"] == 2  # the discount table and the temperature


def test_tracing_changes_no_bit():
    seed = 2**32 + 3
    env, params, states0, _, _ = _case(4, seed)
    quiet = _program(env, params, states0, _noise(15, 13, 4, seed), 15, 13, 0.9)
    (actions, lengths, tree), _, _ = _traced_plan(15, 13)
    assert torch.equal(actions, quiet[0]) and torch.equal(lengths, quiet[1])
    for field in tree._fields:
        assert torch.equal(getattr(tree, field), getattr(quiet[2], field)), field


@pytest.mark.parametrize("handed, copies", [("tensors", 0), ("draws as an array", 1),
                                            ("env draws as an array too", 2),
                                            ("a generator", 0)])
def test_host_syncs_count_what_is_copied_onto_the_device(handed, copies):
    """Beside the discount table and the temperature, each input that is not
    a tensor on the planner's device is copied there."""
    env, params, states0, _, _ = _case(2, 5)
    noise, env_noise, gen = _noise(2, 2, 2, 5), None, None
    if handed != "tensors":
        noise = noise.numpy()
    if handed == "env draws as an array too":
        env_noise = np.zeros((2, 2, 2), np.float32)
    if handed == "a generator":
        noise, gen = None, torch.Generator().manual_seed(0)
    before = counters["host.syncs"]
    mcts_plan_batch(env, params, states0, gen, _probs(), _probs(), num_actions=A, episodes=2,
                    horizon=2, gamma=0.9, temperature=TEMPERATURE, noise=noise,
                    env_noise=env_noise, device="cpu")
    assert counters["host.syncs"] - before == 2 + copies


EPISODE_COUNTERS = ("mcts.episode_eager.calls", "mcts.episode_graph.replays",
                    "mcts.episode_graph.captures")


def _episodes_counted(counted) -> tuple:
    """(eager episodes, replayed episodes, captures) in a counters' increase."""
    return tuple(counted.get(name, 0) for name in EPISODE_COUNTERS)


@pytest.mark.parametrize("form", ["injected draws", "a generator", "grad into an input"])
def test_on_the_cpu_every_episode_runs_eagerly(form):
    episodes, horizon = 3, 2
    env, params, states0, _, _ = _case(2, 17)
    noise, gen = _noise(episodes, horizon, 2, 17), None
    if form == "a generator":
        noise, gen = None, torch.Generator().manual_seed(0)
    if form == "grad into an input":
        states0 = states0._replace(speed=states0.speed.clone().requires_grad_())
    before = counters.copy()
    mcts_plan_batch(env, params, states0, gen, _probs(), _probs(), num_actions=A,
                    episodes=episodes, horizon=horizon, gamma=0.9, temperature=TEMPERATURE,
                    noise=noise, device="cpu")
    counted = counters - before
    assert _episodes_counted(counted) == (episodes, 0, 0)
    assert counted["mcts.steps"] == episodes * horizon


class _Unmarked:
    """The program's env without the mark that its transition draws nothing."""

    def __init__(self, env):
        self.env = env

    def transition(self, *args):
        return self.env.transition(*args)


@pytest.mark.parametrize("form, reason", [
    ("a generator", "draws from a generator"),
    ("an env that may draw", "the env draws from a generator"),
    ("grad into an input", "grad into an input"),
    ("the CPU", "not a CUDA device"),
    ("an env that may draw, its draws injected, on the CPU", "not a CUDA device"),
])
def test_the_rule_names_why_a_plan_runs_its_episodes_eagerly(form, reason):
    env, params, states0, _, _ = _case(2, 19)
    noise, env_noise, device = _noise(2, 2, 2, 19), None, torch.device("cuda")
    inputs = (*states0, noise)
    if form == "a generator":
        noise = None
    if form.startswith("an env that may draw"):
        env = _Unmarked(env)
    if form.endswith("its draws injected, on the CPU"):
        env_noise = torch.zeros((2, 2, 2))
    if form == "grad into an input":
        inputs = (*inputs, torch.ones(A, requires_grad=True))
    if form.endswith("the CPU"):
        device = torch.device("cpu")
    assert episode_graph_declines(env, device, noise, env_noise, inputs) == reason


def test_the_highway_family_draws_nothing_in_its_transition():
    assert not any(e.transition_draws
                   for e in (highway.HighwayEnv, highway.IntersectionEnv, highway.TwoWayEnv))
    assert cartpole.CartPoleEnv.transition_draws


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_host_syncs_equal_the_synchronisations_cuda_reports():
    """One plan of the benchmark's cell (4096 trees, 15 x 13): ``host.syncs``
    rises by the number of synchronising operations
    ``set_sync_debug_mode("warn")`` reports."""
    dev = _card()
    trees = 4096
    env, params, states0, _, _ = _case(trees, 2**31 + 1, dev)
    noise = _noise(15, 13, trees, 2**31 + 1, dev)
    run = lambda: _program(env, params, states0, noise, 15, 13, 0.9, dev)
    run()  # the transition's first call and its capture
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
    print(f"MCTS batch plan: {counted} counted, {reported} reported")
    assert counted == reported > 0


COUNTED = ("mcts.steps", "env.transition_kernel.launches", "host.syncs")


def _counted_plan(env, params, states0, noise, episodes, horizon, device):
    before = counters.copy()
    started = time.perf_counter()
    out = _program(env, params, states0, noise, episodes, horizon, 0.9, device)
    torch.cuda.synchronize(device)
    return out, counters - before, time.perf_counter() - started


def _assert_same_plan(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for field in got[2]._fields:
        assert torch.equal(getattr(got[2], field), getattr(want[2], field)), field


@pytest.mark.card
@pytest.mark.parametrize("trees, episodes", [(4096, 15), (8, 2)])
def test_on_the_card_replayed_episodes_give_the_eager_bits_and_counts(trees, episodes):
    """Three plans of new start states and draws: the graph's (captured in
    the first, a new env's) against the same plans' eager episodes, an env
    without the mark that its transition draws nothing."""
    dev = _card()
    horizon = 13
    env, params, _, _, _ = _case(trees, 2**31 + trees, dev)
    for call in range(3):
        seed = 2**33 + 10 * call + trees
        states0 = _scenes(env, params, trees, seed, dev)
        noise = _noise(episodes, horizon, trees, seed, dev)
        got, counted, graph_s = _counted_plan(env, params, states0, noise, episodes, horizon, dev)
        want, eager, eager_s = _counted_plan(_Unmarked(env), params, states0, noise, episodes,
                                             horizon, dev)
        print(f"B={trees} E={episodes} H={horizon} call {call}: graph {graph_s * 1e3!r} ms, "
              f"eager {eager_s * 1e3!r} ms")
        _assert_same_plan(got, want)
        assert _episodes_counted(counted) == (0, episodes, call == 0)
        assert _episodes_counted(eager) == (episodes, 0, 0)
        assert [counted[k] for k in COUNTED] == [eager[k] for k in COUNTED]
        assert counted["mcts.steps"] == counted["env.transition_kernel.launches"] \
            == episodes * horizon


@pytest.mark.card
def test_on_the_card_a_plan_keeps_its_outputs_after_later_plans():
    dev = _card()
    env, params, states0, _, _ = _case(8, 41, dev)
    first = _program(env, params, states0, _noise(2, 13, 8, 41, dev), 2, 13, 0.9, dev)
    kept = (first[0].clone(), first[1].clone(),
            type(first[2])(*(x.clone() for x in first[2])))
    for seed in (42, 43):
        _program(env, params, _scenes(env, params, 8, seed, dev), _noise(2, 13, 8, seed, dev),
                 2, 13, 0.9, dev)
    torch.cuda.synchronize(dev)
    _assert_same_plan(first, kept)


@pytest.mark.card
def test_on_the_card_plans_of_fewer_episodes_share_the_capture():
    """15, 4 and 2 episodes, as the cell's window and its traced segments
    plan: one capture, one replay an episode, the eager bits."""
    dev = _card()
    trees, horizon = 64, 13
    env, params, states0, _, _ = _case(trees, 51, dev)
    noise = _noise(15, horizon, trees, 51, dev)
    before = counters.copy()
    for episodes in (15, 4, 2):
        got = _program(env, params, states0, noise[:episodes], episodes, horizon, 0.9, dev)
        want = _program(_Unmarked(env), params, states0, noise[:episodes], episodes, horizon,
                        0.9, dev)
        _assert_same_plan(got, want)
    assert _episodes_counted(counters - before) == (21, 21, 1)


@pytest.mark.card
def test_inside_a_users_capture_the_plan_takes_no_graph_of_its_own():
    """A caller's capture is under way: the rule declines, so the planner
    would not begin a capture inside it; outside, the same call is taken."""
    dev = _card()
    env, params, states0, _, _ = _case(8, 61, dev)
    noise = _noise(2, 13, 8, 61, dev)
    inputs = (*states0, *params, noise)
    outer, ran = torch.cuda.CUDAGraph(), torch.zeros(1, device=dev)
    with torch.cuda.graph(outer):
        reason = episode_graph_declines(env, dev, noise, None, inputs)
        ran += 1
    outer.replay()
    torch.cuda.synchronize(dev)
    assert reason == "inside a capture" and int(ran) == 1
    assert episode_graph_declines(env, dev, noise, None, inputs) is None
