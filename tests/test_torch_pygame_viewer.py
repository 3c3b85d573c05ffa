"""The live pygame viewer and agent overlays of the PyTorch port, headless
(SDL dummy driver), against ``rl_agents_tpu/graphics/pygame_viewer.py``:
mirrors ``tests/test_pygame_viewer.py``, and holds every drawn surface pixel
by pixel to JAX's on a state, an arena or weights carried over from JAX.
``Evaluation(display_env=True, display_agent=True)`` creates the viewer,
registers the overlay callback and draws one frame per env step."""
import os

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl_agents_torch.convert import flax_params_to_torch, from_numpy, tree_from_numpy  # noqa: E402
from rl_agents_torch.convert import highway_state_from_numpy  # noqa: E402
from rl_agents_torch.envs import cartpole as torch_cartpole  # noqa: E402
from rl_agents_torch.envs import highway as torch_highway  # noqa: E402
from rl_agents_torch.graphics import pygame_viewer as tv  # noqa: E402
from rl_agents_tpu.envs import cartpole as jax_cartpole  # noqa: E402
from rl_agents_tpu.envs import highway as jax_highway  # noqa: E402
from rl_agents_tpu.graphics import pygame_viewer as jv  # noqa: E402

pygame = pytest.importorskip("pygame")
torch.set_num_threads(1)

SIZE = (160, 60)
MCTS = {"__class__": "MCTSAgent", "budget": 8, "horizon": 4}
DQN = {"model": {"type": "MultiLayerPerceptron", "layers": [8]},
       "batch_size": 4, "memory_capacity": 64}


def _synced_cartpole(seed=0):
    env_j = jax_cartpole.make({})
    env_j.reset(seed=seed)
    env_t = torch_cartpole.make({}, device="cpu")
    env_t.state = from_numpy(torch_cartpole.CartPoleState,
                             {k: np.asarray(v)[None] for k, v in env_j.state._asdict().items()},
                             device="cpu")
    return env_j, env_t


def _mcts_agent(env):
    from rl_agents_torch.factory import agent_factory

    return agent_factory(env, dict(MCTS), device="cpu")


def _frames(env_j, env_t, **draw):
    frames = []
    for module, env in ((tv, env_t), (jv, env_j)):
        viewer = module.PygameViewer(env, size=SIZE, headless=True)
        frames.append(viewer.display(**draw))
        viewer.close()
    return frames


def test_viewer_renders_cartpole_frame():
    env_j, env_t = _synced_cartpole(seed=2)
    got, want = _frames(env_j, env_t)
    assert got.shape == (120, 160, 3) and got.dtype == np.uint8
    assert got.max() > 0  # something was drawn
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [0, 8])
def test_viewer_renders_highway_frame(steps):
    env_j = jax_highway.make({"vehicles_count": 6})
    env_j.reset(seed=0)
    for _ in range(steps):
        env_j.step(3)
    env_t = torch_highway.make({"vehicles_count": 6}, device="cpu")
    env_t.state = highway_state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None],
                                                        env_j.state), device="cpu")
    got, want = _frames(env_j, env_t)
    assert got.shape == (120, 160, 3) and got.max() > 0
    np.testing.assert_array_equal(got, want)


class _Holder:
    """An object with a ``last_plan_data``, as the tree overlay reads it."""

    def __init__(self, tree):
        self.last_plan_data = tree


def test_tree_overlay_draws_jaxs_rectangles_on_a_carried_arena():
    from rl_agents_torch.agents.tree_search.mcts import MCTSTree
    from rl_agents_tpu.factory import agent_factory

    env_j, _ = _synced_cartpole(seed=4)
    agent_j = agent_factory(env_j, {"__class__": "MCTSAgent", "budget": 60, "horizon": 5})
    agent_j.seed(2)
    agent_j.plan(np.asarray(env_j.obs))
    tree_t = tree_from_numpy(MCTSTree, jax.tree.map(np.asarray, agent_j.last_plan_data),
                             device="cpu", batched=False)
    children, values = tv.tree_overlay(tree_t)
    np.testing.assert_array_equal(children, np.asarray(agent_j.last_plan_data.children))
    np.testing.assert_array_equal(values, np.asarray(agent_j.last_plan_data.value))
    pygame.init()
    surfaces = [pygame.Surface(SIZE) for _ in range(2)]
    tv.TreePygameGraphics.display(_Holder(tree_t), surfaces[0])
    jv.TreePygameGraphics.display(_Holder(agent_j.last_plan_data), surfaces[1])
    got, want = (pygame.surfarray.array3d(s) for s in surfaces)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2  # the lowest and highest values
    np.testing.assert_array_equal(got, want)


def test_evaluation_wires_agent_overlay_tree_agent(tmp_path):
    """The overlay path of the reference harness: evaluation creates the
    viewer, hooks the agent display, and each step draws both surfaces."""
    from rl_agents_torch.trainer.evaluation import Evaluation

    env = torch_cartpole.make({"max_episode_steps": 12}, device="cpu")
    agent = _mcts_agent(env)
    evaluation = Evaluation(env, agent, directory=str(tmp_path), num_episodes=1,
                            sim_seed=0, display_env=True, display_agent=True)
    assert evaluation.viewer is not None
    assert evaluation.viewer.agent_display is not None
    drawn = []
    display = evaluation.viewer.display
    evaluation.viewer.display = lambda **kw: drawn.append(display(**kw))
    evaluation.run_episodes()
    assert len(drawn) == int(evaluation.episode_rewards[0]) > 1  # one frame a step
    # the agent surface was painted by the tree overlay (non-black pixels)
    frame = evaluation.viewer.get_image()
    agent_half = frame[frame.shape[0] // 2:]
    assert agent_half.max() > 0
    # ... as the overlay draws the agent's last tree
    pygame.init()
    surface = pygame.Surface(evaluation.viewer.size)
    surface.fill((20, 20, 20))
    tv.TreePygameGraphics.display(agent, surface)
    np.testing.assert_array_equal(agent_half, pygame.surfarray.array3d(surface).swapaxes(0, 1))
    evaluation.close()


def test_evaluation_wires_agent_overlay_dqn(tmp_path):
    from rl_agents_torch.agents.dqn.agent import DQNAgent as TorchDQN
    from rl_agents_torch.trainer.evaluation import Evaluation
    from rl_agents_tpu.agents.dqn.agent import DQNAgent as JaxDQN

    env = torch_cartpole.make({"max_episode_steps": 6}, device="cpu")
    agent = TorchDQN(env, dict(DQN), device="cpu")
    evaluation = Evaluation(env, agent, directory=str(tmp_path), num_episodes=1,
                            sim_seed=0, display_env=True, display_agent=True)
    assert evaluation.viewer is not None
    evaluation.training = False
    evaluation.run_episodes()
    frame = evaluation.viewer.get_image()
    assert frame.shape[2] == 3 and frame[frame.shape[0] // 2:].max() > 0
    evaluation.close()

    # the Q bars of converted flax weights, pixel-equal to JAX's
    env_j, env_t = _synced_cartpole()
    agent_j = JaxDQN(env_j, dict(DQN))
    agent_t = TorchDQN(env_t, dict(DQN), device="cpu")
    flax_params_to_torch(agent_t.model, jax.tree.map(np.asarray, agent_j.train_state.params))
    agent_t.train_state = agent_t.train_state._replace(
        params={k: v.detach().clone() for k, v in agent_t.model.named_parameters()})
    for a in (agent_j, agent_t):
        a.previous_state = np.array([0.02, 0.3, -0.1, 0.4], np.float32)
    pygame.init()
    surfaces = [pygame.Surface(SIZE) for _ in range(2)]
    tv.DQNPygameGraphics.display(agent_t, surfaces[0])
    jv.DQNPygameGraphics.display(agent_j, surfaces[1])
    got, want = (pygame.surfarray.array3d(s) for s in surfaces)
    assert got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_viewer_without_pygame_is_left_out_with_a_warning(tmp_path, monkeypatch, caplog):
    import sys

    from rl_agents_torch.trainer.evaluation import Evaluation

    monkeypatch.setitem(sys.modules, "pygame", None)
    env = torch_cartpole.make({"max_episode_steps": 3}, device="cpu")
    agent = _mcts_agent(env)
    with caplog.at_level("WARNING"):
        evaluation = Evaluation(env, agent, directory=str(tmp_path), num_episodes=1,
                                sim_seed=0, display_env=True, display_agent=True)
    assert evaluation.viewer is None and evaluation.recorder is not None
    assert "pygame unavailable" in caplog.text
    evaluation.close()


def test_a_decision_chance_arena_draws_only_its_decision_ids():
    """MDP-GapE's arena: ``d_children`` name chance nodes, which index no
    decision array. JAX's overlay raises IndexError on the first one past
    the decision arena (a latent defect of the JAX package, ROADMAP.md §3);
    the port drops those ids and draws the rest as JAX would."""
    from rl_agents_torch.agents.tree_search.mdp_gape import GapETree
    from rl_agents_tpu.factory import agent_factory, load_environment

    env_j = load_environment({"id": "finite-mdp", "generator": "garnet", "num_states": 16,
                              "num_actions": 4, "branching": 2, "seed": 0,
                              "max_episode_steps": 3})
    agent_j = agent_factory(env_j, {"__class__": "MDPGapEAgent", "gamma": 0.7, "budget": 30,
                                    "accuracy": 0.0, "confidence": 1.0,
                                    "max_next_states_count": 2})
    agent_j.seed(0)
    agent_j.plan(env_j.reset(seed=0)[0])
    tree_j = agent_j.last_plan_data
    tree_t = tree_from_numpy(GapETree, jax.tree.map(np.asarray, tree_j), device="cpu",
                             batched=False)
    pygame.init()
    with pytest.raises(IndexError):
        jv.TreePygameGraphics.display(_Holder(tree_j), pygame.Surface(SIZE))
    children, values = tv.tree_overlay(tree_t)
    d_children = np.asarray(tree_j.d_children)
    assert (d_children >= len(values)).any()
    np.testing.assert_array_equal(children, np.where(d_children < len(values), d_children, -1))
    surface = pygame.Surface(SIZE)
    tv.TreePygameGraphics.display(_Holder(tree_t), surface)
    assert pygame.surfarray.array3d(surface).max() > 0
