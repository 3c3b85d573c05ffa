"""MDP-GapE on the garnet at ``FiniteMDPEnv/agents/mdp-gape.json``'s settings
(budget 100: 20 episodes of horizon 5, a plan runs 21; gamma 0.7, two
next-state slots) against the benchmark's plain reference
(``perfbench/reference/mdp_gape.py`` over ``perfbench/reference/garnet.py``),
and its tracing.

The port's ``mdp_gape_plan_batch`` plans from seeded start states under the
same Gumbel draws as the reference: the best actions, the episodes run and
every field of the arenas must be equal, the float fields bit for bit (the
same float32 operations in the same order on one device) where the reward
threshold is the configured ``c*np.log(time)``. The agent hands the
configured threshold to its planner. The reference's
constrained expectation is checked on cases worked out by hand, its garnet
against the port's tables. Traced, a plan records its spans
(``planner.plan``; an episode's ``gape.descend`` holding each step's
``env.transition``, then ``gape.bounds``, ``gape.backup`` and
``gape.root``) and counts its episodes, steps and host syncs; tracing
changes no bit.

The tests marked ``card`` need a CUDA card (they skip without one): a
plan's ``host.syncs`` equal the synchronisations that
``torch.cuda.set_sync_debug_mode`` reports, and plans in a row on the
card, their episodes replayed and their chance backups solved by the
constrained solve's kernel (``tests/test_torch_max_expectation_kernel.py``
holds it to the eager solve), equal the reference's. Run them on the card with
``python -m pytest tests/test_torch_mdp_gape_garnet.py -m card -s``."""
import math
import pathlib
import warnings

import pytest
import torch

from perfbench.pbcore import draws as draw
from perfbench.reference import garnet as ref_garnet
from perfbench.reference import mdp_gape as ref_gape
from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch
from rl_agents_torch.envs import finite_mdp
from rl_agents_torch.factory import load_environment
from rl_agents_torch.ops.hashing import obs_key
from rl_agents_torch.trainer import profiling
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils import math as tm

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "configs" / "FiniteMDPEnv"

# the benchmark's garnet and MDP-GapE agent (perfbench/configs/mdp-gape-garnet.json)
GARNET = {"id": "finite-mdp", "generator": "garnet", "num_states": 16, "num_actions": 4,
          "branching": 2, "seed": 0, "max_episode_steps": 20}
A, K, W = 4, 2, 2
SETTINGS = dict(num_actions=A, width=W, gamma=0.7, accuracy=0.0, transition_threshold_coeff=0.1)
# mdp-gape.json's upper_bound.threshold, and its coefficient of log(time)
THRESHOLD, COEFF = "1*np.log(time)", 1.0


class _RefEnv:
    """The garnet's plain reference as the reference planner steps it (the
    benchmark's ``perfbench/envs/finite-mdp.py``)."""
    transition = staticmethod(ref_garnet.step)


def _case(trees: int, seed: int, device="cpu"):
    """The program's env, params and start states, and the reference's model
    and start states, from the same seeded draw."""
    handle = load_environment(dict(GARNET), device=device)
    env, params = handle.functional, handle.params
    model = ref_garnet.to(ref_garnet.model_of(GARNET), device)
    starts = torch.randint(0, 16, (trees,), generator=draw.generator(seed, draw.SCENES, 0, device),
                           device=device)
    states0, _ = env.reset(params, None, trees, noise=starts)
    return env, params, states0, model, ref_garnet.reset(model, starts)


def _draws(episodes: int, horizon: int, trees: int, seed: int, device="cpu"):
    gen = draw.generator(seed, draw.PLAN, 0, device)
    noise = draw.gumbel((episodes + 1, horizon, trees, A), gen)
    return noise, draw.gumbel((episodes + 1, horizon, trees, K), gen)


def _program(env, params, states0, drawn, episodes, horizon, confidence, coeff=COEFF,
             device="cpu"):
    noise, env_noise = drawn
    return mdp_gape_plan_batch(env, params, states0, None, episodes=episodes, horizon=horizon,
                               confidence=confidence, noise=noise, env_noise=env_noise,
                               device=device, reward_threshold_coeff=coeff, **SETTINGS)


def _reference(model, starts, drawn, episodes, horizon, confidence, threshold=THRESHOLD):
    noise, env_noise = drawn
    return ref_gape.plan(_RefEnv, model, starts, noise, env_noise, episodes=episodes,
                         horizon=horizon, confidence=confidence, threshold=threshold, **SETTINGS)


# the reward threshold as the configuration spells it, and as the port takes
# it: mdp-gape.json's (confidence then enters no bound), OLOP's default, and
# upstream's default BAI threshold, the port's without a configured one
THRESHOLDS = [(THRESHOLD, COEFF, 1.0), ("4*np.log(time)", 4.0, 0.9),
              (ref_gape.DEFAULT_THRESHOLD, None, 0.9)]


@pytest.mark.parametrize("threshold, coeff, confidence", THRESHOLDS)
@pytest.mark.parametrize("trees, episodes, horizon", [(8, 20, 5), (1, 20, 5), (16, 4, 3)])
def test_the_port_plans_as_the_reference(trees, episodes, horizon, threshold, coeff, confidence):
    seed = 2**31 + 97 * trees + episodes
    env, params, states0, model, starts = _case(trees, seed)
    drawn = _draws(episodes, horizon, trees, seed)
    best, used, tree = _program(env, params, states0, drawn, episodes, horizon, confidence,
                                coeff)
    want_best, want_used, want = _reference(model, starts, drawn, episodes, horizon, confidence,
                                            threshold)
    assert torch.equal(best, want_best) and torch.equal(used, want_used)
    # bit for bit at the default BAI threshold too, though the port computes
    # it in float32 and upstream in float64 (1 ulp apart at some counts)
    for field in tree._fields:
        assert torch.equal(getattr(tree, field), getattr(want, field)), field
    assert used.tolist() == [episodes + 1] * trees  # at accuracy 0 no tree stops
    assert int(tree.d_count[:, 1:].sum()) == trees * (episodes + 1) * horizon
    # both slots of some chance node are filled: the constrained solve runs
    assert bool((tree.c_n_children == W).any())
    # the reward bounds are informative: some visited node's are not [0, 1]
    visited = tree.d_count > 0
    assert bool(((tree.d_mu_ucb < 1) & visited).any())
    assert bool(((tree.d_mu_lcb > 0) & visited).any())


def test_the_reference_takes_upstreams_default_threshold_as_upstream_does():
    """At confidence 1.0 upstream's default BAI threshold divides by zero;
    the configured one is log(time) at every count."""
    with pytest.raises(ZeroDivisionError):
        ref_gape.reward_thresholds(ref_gape.DEFAULT_THRESHOLD, 3, 5, 4, 1.0, 20, "cpu")
    table = ref_gape.reward_thresholds(THRESHOLD, 22, 5, 4, 1.0, 20, "cpu")
    assert torch.equal(table, torch.full((22,), math.log(20), dtype=torch.float32))


def test_the_agent_hands_the_configured_threshold_to_its_planner(monkeypatch):
    """``mdp-gape.json`` through ``load_agent``: the plan takes its
    ``upper_bound.threshold``; an agent configured without one takes the
    BAI threshold."""
    from rl_agents_torch.agents.tree_search import mdp_gape
    from rl_agents_torch.factory import load_agent

    taken = []
    plan = mdp_gape.mdp_gape_plan

    def recorded(*args, **kwargs):
        taken.append(kwargs["reward_threshold_coeff"])
        return plan(*args, **kwargs)

    monkeypatch.setattr(mdp_gape, "mdp_gape_plan", recorded)
    env = load_environment(CONFIGS / "env_garnet.json", device="cpu")
    agent = load_agent(CONFIGS / "agents" / "mdp-gape.json", env, device="cpu")
    plain = mdp_gape.MDPGapEAgent(env, {"budget": 20, "confidence": 0.9}, device="cpu")
    obs, _ = env.reset(seed=0)
    for a in (agent, plain):
        a.seed(0)
        assert a.act(obs) in range(A)
    assert taken == [COEFF, None]


def test_the_reference_solves_chance_backups_worked_out_by_hand():
    f = torch.tensor([[1.0, 0.0], [0.0, 1.0], [2.0, 2.0], [1.0, 0.0]])
    q = torch.tensor([[0.5, 0.5], [1.0, 0.0], [0.25, 0.75], [0.0, 0.0]])
    c = torch.tensor([math.log(1.25), math.log(2.0), 0.3, math.log(1.25)])
    p = ref_gape.max_expectation(f, q, c)
    # two atoms of equal mass: KL(q || p) = -log(4 p (1 - p)) / 2 = log 1.25 at p = 0.8
    assert torch.allclose(p[0], torch.tensor([0.8, 0.2]), atol=1e-4)
    # the better atom has no mass: it takes z = 1 - exp(-c) = 1/2, KL = log 2
    assert torch.allclose(p[1], torch.tensor([0.5, 0.5]), atol=1e-6)
    # f constant on the support: p = q
    assert torch.equal(p[2], q[2])
    # no mass seen at all: taken as uniform, then as the first row
    assert torch.allclose(p[3], p[0], atol=1e-6)
    # a chance backup's value: E_p[mu + gamma v] over its next states
    upper = torch.tensor([[1.0 + 0.7 * 2.0, 0.5 + 0.7 * 0.0]])
    p = ref_gape.max_expectation(upper, torch.tensor([[0.5, 0.5]]),
                                 torch.tensor([math.log(1.25)]))
    assert abs(float((p * upper).sum()) - (0.8 * 2.4 + 0.2 * 0.5)) < 1e-3


def test_the_reference_garnet_is_the_programs():
    env, params = finite_mdp.garnet(torch.Generator().manual_seed(0), 16, 4, 2)
    model = ref_garnet.draw(0, 16, 4, 2)
    assert torch.equal(model.next, params.next)
    assert torch.equal(model.probs, params.transition)
    assert torch.equal(model.reward, params.reward)
    assert torch.equal(model.terminal, params.terminal)
    # half the rewards are 0, the probabilities sum to 1 over the branches
    assert 0 < int((model.reward == 0).sum()) < 64
    assert torch.allclose(model.probs.sum(dim=-1), torch.ones(16, 4))
    keys = torch.tensor([ref_gape.state_key(s) for s in range(16)])
    assert torch.equal(keys, obs_key(torch.arange(16)))
    # a step under the same draws
    starts = torch.arange(16).repeat(4)
    actions = torch.arange(4).repeat_interleave(16)
    gumbel = draw.gumbel((64, K), torch.Generator().manual_seed(5))
    out = env.step(params, env.reset(params, None, 64, noise=starts)[0], actions, None, gumbel)
    state, reward, terminated = ref_garnet.step(model, ref_garnet.reset(model, starts), actions,
                                                gumbel)
    assert torch.equal(out.state.s, state.s) and torch.equal(out.reward, reward)
    assert torch.equal(out.terminated, terminated)


def test_reset_puts_each_tree_at_its_drawn_state():
    handle = load_environment(dict(GARNET), device="cpu")
    env, params = handle.functional, handle.params
    starts = torch.tensor([3, 0, 15, 7])
    state, obs = env.reset(params, None, 4, noise=starts)
    assert state.s.tolist() == [3, 0, 15, 7] and torch.equal(obs, state.s)
    assert state.t.tolist() == [0] * 4 and not bool(state.done.any())
    plain, _ = env.reset(params, None, 4)
    assert plain.s.tolist() == [0] * 4  # without noise, every state at initial_state
    drawn = env.reset_noise(params, None, 4)
    assert torch.equal(env.reset(params, None, 4, noise=drawn)[0].s, plain.s)


def test_a_transition_without_draws_takes_the_null_draw():
    """``transition`` of a stochastic MDP given neither a generator nor noise
    steps under ``null_noise`` and leaves PyTorch's default generator as it
    was; ``step`` asks for one."""
    handle = load_environment(dict(GARNET), device="cpu")
    env, params = handle.functional, handle.params
    state, _ = env.reset(params, None, 64, noise=torch.arange(16).repeat(4))
    actions = torch.arange(4).repeat_interleave(16)
    rng = torch.get_rng_state()
    out = env.transition(params, state, actions)
    assert torch.equal(torch.get_rng_state(), rng)
    want = env.step(params, state, actions, None, env.null_noise(64, "cpu"))
    assert torch.equal(out.state.s, want.state.s) and torch.equal(out.reward, want.reward)
    with pytest.raises(ValueError, match="generator or injected noise"):
        env.step(params, state, actions)


def _traced_plan(episodes, horizon, trees=4, confidence=1.0):
    seed = 2**32 + 3
    env, params, states0, _, _ = _case(trees, seed)
    drawn = _draws(episodes, horizon, trees, seed)
    profiling.take()
    before = counters.copy()
    profiling.enable()
    try:
        out = _program(env, params, states0, drawn, episodes, horizon, confidence)
    finally:
        profiling.disable()
    return out, profiling.take(), counters - before


@pytest.mark.parametrize("episodes, horizon", [(20, 5), (2, 3)])
def test_a_traced_plan_records_its_spans_and_counts(episodes, horizon):
    _, spans, counted = _traced_plan(episodes, horizon)
    names = [s.name for s in spans]
    runs = episodes + 1
    assert names[0] == "planner.plan" and names[-1] == "gape.root"
    assert {name: names.count(name) for name in set(names)} == {
        "planner.plan": 1, "gape.descend": runs, "env.transition": runs * horizon,
        "gape.bounds": runs, "gape.backup": runs, "gape.root": runs + 1}
    episode = ["gape.descend"] + ["env.transition"] * horizon \
        + ["gape.bounds", "gape.backup", "gape.root"]
    assert names[1:-1] == episode * runs
    plan = spans[0]
    for i, s in enumerate(spans[1:], start=1):
        assert s.root == 0 and plan.start_ns <= s.start_ns <= s.end_ns <= plan.end_ns
        if s.name == "env.transition":
            assert spans[s.parent].name == "gape.descend"
        else:
            assert s.parent == 0
    assert counted["gape.episodes"] == runs and counted["gape.steps"] == runs * horizon
    calls, trips = counted["newton_iteration.calls"], counted["newton_iteration.trips"]
    assert calls == runs * horizon  # one solve a chance backup, both problems in it
    # every solve here ends at a block's read-back: syncs are the five host
    # values and the Newton solves' read-backs
    assert trips % 8 == 0 and trips < 100 * calls
    assert counted["host.syncs"] == 5 + trips // 8


def test_tracing_changes_no_bit():
    seed = 2**32 + 3
    env, params, states0, _, _ = _case(4, seed)
    quiet = _program(env, params, states0, _draws(20, 5, 4, seed), 20, 5, 0.9)
    (best, used, tree), _, _ = _traced_plan(20, 5, confidence=0.9)
    assert torch.equal(best, quiet[0]) and torch.equal(used, quiet[1])
    for field in tree._fields:
        assert torch.equal(getattr(tree, field), getattr(quiet[2], field)), field


@pytest.mark.parametrize("handed, copies", [("tensors", 0), ("draws as an array", 1),
                                            ("env draws as an array too", 2),
                                            ("a generator", 0)])
def test_host_syncs_count_what_is_copied_onto_the_device(handed, copies):
    """Beside the five host values and the Newton solves' syncs, each draw
    that is not a tensor on the planner's device is copied there."""
    env, params, states0, _, _ = _case(2, 5)
    noise, env_noise = _draws(2, 2, 2, 5)
    gen = None
    if handed != "tensors":
        noise = noise.numpy()
    if handed == "env draws as an array too":
        env_noise = env_noise.numpy()
    if handed == "a generator":
        noise, env_noise, gen = None, None, torch.Generator().manual_seed(0)
    before = counters.copy()
    mdp_gape_plan_batch(env, params, states0, gen, episodes=2, horizon=2, confidence=1.0,
                        noise=noise, env_noise=env_noise, device="cpu",
                        reward_threshold_coeff=COEFF, **SETTINGS)
    counted = counters - before
    newton = counted["newton_iteration.trips"] // 8
    assert counted["host.syncs"] - newton == 5 + copies


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_host_syncs_equal_the_synchronisations_cuda_reports():
    """One plan of the benchmark's cell (4096 trees, 21 x 5): ``host.syncs``
    rises by the number of synchronising operations
    ``set_sync_debug_mode("warn")`` reports."""
    dev = _card()
    trees = 4096
    env, params, states0, _, _ = _case(trees, 2**31 + 1, dev)
    drawn = _draws(20, 5, trees, 2**31 + 1, dev)
    run = lambda: _program(env, params, states0, drawn, 20, 5, 1.0, device=dev)
    run()  # the KL library's first load
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
    print(f"MDP-GapE batch plan: {counted} counted, {reported} reported")
    assert counted == reported > 0


@pytest.mark.card
def test_plans_on_the_card_are_the_references():
    """The benchmark's cell cut to 64 trees, on the card, three plans in a
    row from other start states and draws (the last of 4 episodes, which
    the arenas sized for 20 hold): each plan's best actions, episodes and
    every arena field equal the reference's, the episode is captured once
    and replayed at every episode, and the first plan's output is not
    touched by the later ones; every chance backup's solve is one launch
    of the solve's kernel."""
    from rl_agents_torch.agents.tree_search import mdp_gape

    dev = _card()
    mdp_gape._graphs.clear()
    before = counters.copy()
    kept = env = params = None
    for seed, episodes in ((2**32 + 17, 20), (2**33 + 5, 20), (2**31 + 9, 4)):
        case_env, case_params, states0, model, starts = _case(64, seed, dev)
        if env is None:  # one env and its params for every plan, as a benchmark run holds them
            env, params = case_env, case_params
        drawn = _draws(episodes, 5, 64, seed, dev)
        best, used, tree = _program(env, params, states0, drawn, episodes, 5, 1.0, device=dev)
        want_best, want_used, want = _reference(model, starts, drawn, episodes, 5, 1.0)
        assert torch.equal(best, want_best) and torch.equal(used, want_used)
        for field in tree._fields:
            assert torch.equal(getattr(tree, field), getattr(want, field)), field
        if kept is None:
            kept = (tree, {f: getattr(tree, f).clone() for f in tree._fields})
    for field, value in kept[1].items():
        assert torch.equal(getattr(kept[0], field), value), field
    counted = counters - before
    assert counted["gape.episode_graph.captures"] == 1
    assert counted["gape.episode_graph.replays"] == 21 + 21 + 5
    # every chance backup's solve (H a run) a launch of the solve's kernel
    assert counted["max_expectation_under_constraint.kernel_launches"] == (21 + 21 + 5) * 5
    assert counted["max_expectation_under_constraint.eager_calls"] == 0
