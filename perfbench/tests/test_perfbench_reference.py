"""The plain reference against the program on the CPU at small sizes under
the same draws, and each count against a hand count at one small shape."""
import pytest
import torch

from perfbench.counts import highway as highway_counts
from perfbench.counts import kl as kl_counts
from perfbench.counts import olop as olop_counts
from perfbench.counts import opd as opd_counts
from perfbench.pbcore import draws as draw
from perfbench.planners import olop as olop_planner
from perfbench.planners import opd as opd_planner
from perfbench.envs import highway as env_highway
from perfbench.reference import kl as ref_kl

ENV = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
OPD = {"sizes": {"num_actions": 5, "expansions": 20, "plan_capacity": 20, "gamma": 0.9,
                 "terminal_reward": 0.0, "vehicles": 15}, "env": ENV}
OLOP = {"sizes": {"num_actions": 5, "episodes": 12, "horizon": 6, "gamma": 0.7,
                  "threshold_coeff": 2.0, "vehicles": 15}, "env": ENV}


def program_env(device):
    from rl_agents_torch.factory import load_environment

    handle = load_environment(dict(ENV), device=device)
    return handle.functional, handle.params


def scenes(device, trees, seed):
    env, params = program_env(device)
    gen = draw.generator(seed, draw.SCENES, 0, device)
    drawn = env_highway.scene_draws(gen, trees, env_highway.model(ENV))
    states, _ = env.reset(params, gen, trees, noise=drawn)
    return env, params, drawn, states


def same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def check_highway(device, trees, steps):
    env, params, drawn, states = scenes(device, trees, 11)
    model = env_highway.model(ENV)
    ref = env_highway.reset(model, drawn)
    same(states, ref)
    gen = draw.generator(11, draw.PLAN, 0, device)
    for _ in range(steps):
        action = torch.randint(0, 5, (trees,), generator=gen, device=device)
        out = env.transition(params, states, action)
        ref, reward, crashed = env_highway.transition(model, ref, action)
        same(out.state, ref)
        assert torch.equal(out.reward, reward) and torch.equal(out.terminated, crashed)
        states = out.state


def check_plans(planner, config, device, trees):
    env, params, drawn, states = scenes(device, trees, 12)
    plan = planner.plan_draws(config, trees, draw.generator(12, draw.PLAN, 0, device))
    got = planner.program_plan(config, env, params, states, plan, device)
    model = env_highway.model(ENV)
    want = planner.reference_plan(config, env_highway, model, env_highway.reset(model, drawn),
                                  plan)
    for field in planner.DISCRETE + planner.FLOATS:
        assert torch.equal(got[field], want[field]), field
    if planner.STATES:
        same(got["states"], want["states"])


def test_highway_transition_equals_the_program():
    check_highway(torch.device("cpu"), 64, 12)


def test_opd_plan_equals_the_program():
    check_plans(opd_planner, OPD, torch.device("cpu"), 6)


def test_olop_plan_equals_the_program():
    check_plans(olop_planner, OLOP, torch.device("cpu"), 4)


def test_kl_bound_equals_the_programs_plain_solve():
    from rl_agents_torch.ops.kl_bound import kl_bound_torch

    gen = torch.Generator().manual_seed(3)
    count = torch.randint(0, 20, (512,), generator=gen).float()
    total = torch.rand(512, generator=gen) * count
    threshold = torch.tensor(2.0) * torch.log(torch.tensor(72.0))
    got = ref_kl.upper_bound(total, count, threshold)
    assert torch.equal(got, kl_bound_torch(total, count, threshold, iters=100))


def test_opd_action_values_are_the_root_childrens_lower_bounds():
    env, params, drawn, states = scenes(torch.device("cpu"), 3, 13)
    model = env_highway.model(ENV)
    plan = opd_planner.plan_draws(OPD, 3, draw.generator(13, draw.PLAN, 0, torch.device("cpu")))
    got = opd_planner.program_plan(OPD, env, params, states, plan, torch.device("cpu"))
    values = opd_planner.action_values(OPD, env_highway, model, env_highway.reset(model, drawn))
    first = got["actions"][:, 0]
    assert torch.equal(values.gather(1, first[:, None]).squeeze(1), values.amax(dim=1))


@pytest.mark.parametrize("count, hand", [
    (lambda: highway_counts.transition_ops(1, 2), 59 * 4 + 220 * 2 + 10),
    (lambda: highway_counts.transition_bytes(1, 2), 2 * (21 * 2 + 17) + 12),
    (lambda: kl_counts.launch_bytes(3), 24 * 3 + 4),
    (lambda: kl_counts.launch_ops(3), 4 * 3 + 18 * 3),
    (lambda: kl_counts.launch_ops(1), 4 + 18),
    # 2 actions, 1 expansion: 3 nodes, 2 transitions, a plan of 1
    (lambda: opd_counts.plan_ops(1, 2, 2, 1, 1), 2 * 686 + (2 * 3 + 5 * 2) + 3 * 3 * 2 + 3 * 2),
    (lambda: opd_counts.plan_bytes(1, 2, 2, 1), 2 * 130 + 3 * (4 * 8 + 2 * 8 + 3 * 4 + 2)),
    # 2 actions, 1 episode of horizon 1: 3 nodes, 1 transition, one KL node
    (lambda: olop_counts.plan_ops(1, 2, 2, 1, 1), 686 + (1 * (2 * 2 + 2) + 2 * (2 + 2)) + 4 * 2
     + 22),
    (lambda: olop_counts.plan_bytes(1, 2, 2, 1, 1), 130 + 28 + 3 * (3 * 8 + 2 * 8 + 3 * 4 + 1)),
])
def test_counts_match_a_hand_count(count, hand):
    assert count() == hand


@pytest.mark.card
def test_reference_equals_the_program_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    device = torch.device("cuda", 0)
    check_highway(device, 4096, 6)
    check_plans(opd_planner, OPD, device, 512)
    check_plans(olop_planner, OLOP, device, 512)
