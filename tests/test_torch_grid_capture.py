"""The stochastic grid (``envs/gridenv.py``) under a CUDA-graph capture.

``GridEnv.step`` keeps its move table and reward centre on the device, made
once a device, so a step copies nothing from the host and a CUDA graph can
capture it. MDP-GapE's episode graph (``mdp_gape.py::_EpisodeGraph``)
captures the step wherever every draw is given, as on
``DummyEnv/gridenv_stoch.json``. Both tests need a CUDA card (marker
``card``; they skip without one): run them with
``python -m pytest tests/test_torch_grid_capture.py -m card -s``."""
import json
import pathlib

import numpy as np
import pytest
import torch

from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch
from rl_agents_torch.envs import gridenv
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils.noise import gumbel, uniform

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "configs" / "DummyEnv"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_a_grid_step_is_captured_by_a_cuda_graph():
    """A captured step's replays give the eager step's bits, on new states
    too."""
    dev = _card()
    env = gridenv.GridEnv(use_diagonals=True, stochasticity=0.3)
    params = env.default_params(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    state = gridenv.GridState(torch.randint(-5, 6, (64, 2), generator=gen, device=dev).float(),
                              torch.zeros(64, dtype=torch.int64, device=dev))
    action = torch.randint(0, 8, (64,), generator=gen, device=dev)
    noise = torch.rand(64, generator=gen, device=dev)
    step = lambda: env.step(params, state, action, noise=noise)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # one run before the capture, as the episode graph makes
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for _ in range(2):
        graph.replay()
        want = step()
        assert torch.equal(captured.state.x, want.state.x)
        assert torch.equal(captured.reward, want.reward)
        state.x.copy_(want.state.x)


@pytest.mark.card
def test_mdp_gape_on_the_stochastic_grid_replays_its_episodes():
    """``DummyEnv/agents/mdp-gape.json``'s planner on ``gridenv_stoch.json``
    at 64 trees, 4 (+1) episodes of horizon 5, every draw given: the episode
    is captured once and replayed at every episode, and the plan's actions,
    episodes and tree structure equal the CPU's under the same draws."""
    dev = _card()
    config = json.loads((CONFIGS / "gridenv_stoch.json").read_text())
    env = gridenv.make_grid(config, device="cpu").functional
    plan = dict(num_actions=4, episodes=4, horizon=5, gamma=0.7, accuracy=0.0, confidence=1.0,
                transition_threshold_coeff=0.1, width=2)
    trees, steps = 64, (plan["episodes"] + 1, plan["horizon"], 64)
    g = torch.Generator(device=dev).manual_seed(13)
    noise, env_noise = gumbel(steps + (4,), g, dev), uniform(steps, g, dev)
    # starts around the reward bump at (10, 10), so that rewards and bounds differ
    start = np.random.default_rng(9).integers(4, 17, (trees, 2)).astype(np.float32)

    def run(device):
        states = gridenv.GridState(torch.tensor(start, device=device),
                                   torch.zeros(trees, dtype=torch.int64, device=device))
        return mdp_gape_plan_batch(env, env.default_params(device), states,
                                   noise=noise.to(device), env_noise=env_noise.to(device),
                                   device=device, **plan)

    before = counters.copy()
    best, used, tree = run(dev)
    counted = counters - before
    assert counted["gape.episode_graph.replays"] == plan["episodes"] + 1
    assert counted["gape.episode_graph.captures"] <= 1
    want_best, want_used, want = run(torch.device("cpu"))
    assert torch.equal(best.cpu(), want_best) and torch.equal(used.cpu(), want_used)
    for field in ("d_count", "d_children", "c_count", "c_children", "c_child_keys"):
        assert torch.equal(getattr(tree, field).cpu(), getattr(want, field)), field
