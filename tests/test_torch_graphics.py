"""The graphics of the PyTorch port against ``rl_agents_tpu/graphics`` and
``rl_agents_tpu/trainer/graphics.py``, mirroring ``tests/test_graphics.py``:
what each figure shows is held to JAX's figure on the CPU, not only that a
figure exists. The Q bars, the value map and the attention matrix come from
flax weights converted with ``convert.flax_params_to_torch``; the Q-table
heatmap and the EPC ellipsoids from the same data; the BFTQ frontier from
converted weights under ``jax.disable_jit()`` (JAX compiled fuses the hull's
cross product, ``tests/test_torch_bftq.py``); the renderers' frames pixel by
pixel on states carried over from JAX; ``TreePlot``'s lines on arenas
carried over from JAX."""
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl_agents_torch.agents.dqn.agent import DQNAgent as TorchDQNAgent  # noqa: E402
from rl_agents_torch.convert import (  # noqa: E402
    flax_params_to_torch,
    from_numpy,
    highway_state_from_numpy,
    tree_from_numpy,
)
from rl_agents_torch.envs import cartpole as torch_cartpole  # noqa: E402
from rl_agents_torch.envs import highway as torch_highway  # noqa: E402
from rl_agents_torch.graphics import agent_graphics as tg  # noqa: E402
from rl_agents_torch.graphics import render as tr  # noqa: E402
from rl_agents_torch.graphics.robust_graphics import RobustEPCGraphics  # noqa: E402
from rl_agents_torch.graphics.tree_plot import TreePlot, tree_row  # noqa: E402
from rl_agents_torch.trainer.graphics import RewardViewer  # noqa: E402
from rl_agents_torch.trainer.state_sampler import CartPoleStateSampler  # noqa: E402
from rl_agents_tpu.agents.dqn.agent import DQNAgent as JaxDQNAgent  # noqa: E402
from rl_agents_tpu.envs import cartpole as jax_cartpole  # noqa: E402
from rl_agents_tpu.envs import highway as jax_highway  # noqa: E402
from rl_agents_tpu.graphics import agent_graphics as jg  # noqa: E402
from rl_agents_tpu.graphics import render as jr  # noqa: E402
from rl_agents_tpu.graphics import robust_graphics as jrg  # noqa: E402
from rl_agents_tpu.graphics import tree_plot as jtp  # noqa: E402
from rl_agents_tpu.trainer import graphics as jtg  # noqa: E402
from rl_agents_tpu.trainer.state_sampler import CartPoleStateSampler as JaxSampler  # noqa: E402

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
ATTENTION = {"type": "EgoAttentionNetwork",
             "embedding_layer": {"layers": [16]}, "others_embedding_layer": {"layers": [16]},
             "attention_layer": {"feature_size": 16, "heads": 2},
             "output_layer": {"layers": [16]}}
LOOP_MDP = {"mode": "deterministic",
            "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
            "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
            "terminal": [0, 0, 0, 0]}


def _synced_dqn(env_j, env_t, config):
    """A DQN agent in each package, the port's with the JAX agent's weights."""
    agent_j = JaxDQNAgent(env_j, dict(config))
    agent_t = TorchDQNAgent(env_t, dict(config), device="cpu")
    flax_params_to_torch(agent_t.model, jax.tree.map(np.asarray, agent_j.train_state.params))
    agent_t.train_state = agent_t.train_state._replace(
        params={k: v.detach().clone() for k, v in agent_t.model.named_parameters()})
    return agent_j, agent_t


def _synced_cartpole(seed=0):
    env_j = jax_cartpole.make({})
    env_j.reset(seed=seed)
    env_t = torch_cartpole.make({}, device="cpu")
    env_t.state = from_numpy(torch_cartpole.CartPoleState,
                             {k: np.asarray(v)[None] for k, v in env_j.state._asdict().items()},
                             device="cpu")
    return env_j, env_t


def _synced_highway(config, seed=0, steps=0):
    env_j = jax_highway.make(dict(config))
    env_j.reset(seed=seed)
    for _ in range(steps):
        env_j.step(1)
    env_t = torch_highway.make(dict(config), device="cpu")
    env_t.state = highway_state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None],
                                                        env_j.state), device="cpu")
    return env_j, env_t


def test_dqn_graphics_and_value_viewer():
    env_j, env_t = _synced_cartpole()
    config = {"model": {"type": "MultiLayerPerceptron", "layers": [8]}}
    agent_j, agent_t = _synced_dqn(env_j, env_t, config)
    state = np.array([0.1, -0.2, 0.05, 0.3], np.float32)
    for agent in (agent_j, agent_t):
        agent.previous_state = state
    fig_j, fig_t = jg.DQNGraphics.display(agent_j), tg.DQNGraphics.display(agent_t)
    heights = [[p.get_height() for p in f.axes[0].patches] for f in (fig_t, fig_j)]
    np.testing.assert_allclose(heights[0], heights[1], atol=1e-6)
    assert tg.AgentGraphics.display(agent_t) is not None
    viewer_t = tg.ValueFunctionViewer(agent_t, CartPoleStateSampler(resolution=5))
    viewer_j = jg.ValueFunctionViewer(agent_j, JaxSampler(resolution=5))
    xx, yy, values = viewer_t.values_mesh()
    mesh_j = viewer_j.plot_to_writer().axes[0].collections[0]
    np.testing.assert_allclose(values.ravel(), np.asarray(mesh_j.get_array()).ravel(), atol=1e-6)
    mesh_t = viewer_t.plot_to_writer().axes[0].collections[0]
    np.testing.assert_array_equal(np.asarray(mesh_t.get_array()).ravel(), values.ravel())
    assert xx.shape == (5, 5)


def test_attention_matrix_extraction():
    env_j, env_t = _synced_highway({"vehicles_count": 6})
    agent_j, agent_t = _synced_dqn(env_j, env_t, {"model": ATTENTION})
    obs = np.asarray(env_j.obs)
    want = jg.DQNGraphics.attention_matrix(agent_j, obs)
    got = tg.DQNGraphics.attention_matrix(agent_t, obs)
    assert got.shape == want.shape == (2, 1, 6)  # heads x ego x entities
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.ptp(got) > 1e-3
    mlp = TorchDQNAgent(env_t, {"model": {"type": "MultiLayerPerceptron", "layers": [8]}},
                        device="cpu")
    assert tg.DQNGraphics.attention_matrix(mlp, obs) is None


def test_epc_ellipsoid_plot():
    from rl_agents_torch.agents.robust.robust_epc import RobustEPCAgent as TorchEPC
    from rl_agents_torch.envs.linear import make as torch_make_linear
    from rl_agents_tpu.agents.robust.robust_epc import RobustEPCAgent as JaxEPC
    from rl_agents_tpu.envs.linear import make as jax_make_linear

    config = {"A": [[0.0, 1.0], [0.0, 0.0]], "B": [[0.0], [1.0]], "D": [[0.0], [1.0]],
              "phi": [[[0.0, 0.0], [0.0, -1.0]]], "sigma": [[1.0, 0.0], [0.0, 1.0]],
              "sub_agent": {"__class__": "DeterministicPlannerAgent", "budget": 6}}
    env_j = jax_make_linear({})
    agent_j = JaxEPC(env_j, dict(config))
    agent_t = TorchEPC(torch_make_linear({}, device="cpu"), dict(config), device="cpu")
    obs, _ = env_j.reset(seed=0)
    for _ in range(3):
        obs, *_ = env_j.step(1)
        for agent in (agent_j, agent_t):
            agent.record_transition(np.asarray(obs["state"]), np.asarray(obs["derivative"]),
                                    np.array([1.0]))
    lines_j = jrg.RobustEPCGraphics.display_ellipsoids(agent_j).axes[0].lines
    curves = RobustEPCGraphics.ellipsoid_curves(agent_t)
    assert len(curves) == len(lines_j) == 4
    for (xs, ys, alpha), line in zip(curves, lines_j):
        np.testing.assert_allclose(xs, line.get_xdata(), atol=1e-9)
        np.testing.assert_allclose(ys, line.get_ydata(), atol=1e-9)
        assert alpha == line.get_alpha()
    lines_t = RobustEPCGraphics.display_ellipsoids(agent_t).axes[0].lines
    assert [list(line.get_xdata()) for line in lines_t] == [list(c[0]) for c in curves]
    assert tg.AgentGraphics.display(agent_t) is not None


def test_interval_trajectory_envelope():
    from rl_agents_torch.robust import interval as torch_interval
    from rl_agents_tpu.robust import interval as jax_interval

    rng = np.random.default_rng(3)
    a0, da = rng.normal(size=(2, 2)) * 0.5, rng.normal(size=(2, 2, 2)) * 0.2
    b, d = rng.normal(size=(2, 1)), rng.normal(size=(2, 1))
    x0 = rng.normal(size=2).astype(np.float32)
    controls = rng.uniform(-1, 1, (20, 1)).astype(np.float32)
    lpv_j = jax_interval.make_lpv(a0, da, x0, b, d, [[-0.1], [0.2]])
    lpv_t = torch_interval.make_lpv(a0, da, x0[None], b, d, [[-0.1], [0.2]], device="cpu")
    lo, hi = RobustEPCGraphics.interval_envelope(lpv_t, controls[:, None], 0.05)
    lo_j, hi_j = (np.asarray(x) for x in jax_interval.lpv_trajectory(
        lpv_j, jnp.asarray(controls), 0.05))
    scale = np.abs(hi_j - lo_j).max()
    assert lo.shape == lo_j.shape == (20, 2)
    np.testing.assert_allclose(lo, lo_j, atol=1e-6 * scale)
    np.testing.assert_allclose(hi, hi_j, atol=1e-6 * scale)
    fig = RobustEPCGraphics.display_interval_trajectory(lpv_t, controls[:, None], 0.05)
    assert len(fig.axes[0].collections) == 2


def test_renderers_are_pixel_equal_to_jax():
    env_j, env_t = _synced_cartpole(seed=3)
    assert tr.cartpole_frame(env_t) == {"x": float(env_j.state.x),
                                        "theta": float(env_j.state.theta)}
    frame_t = tr.CartPoleRenderer().render(env_t)
    assert frame_t.ndim == 3 and frame_t.shape[2] == 3
    np.testing.assert_array_equal(frame_t, jr.CartPoleRenderer().render(env_j))
    for steps in (0, 6):
        env_j, env_t = _synced_highway({"vehicles_count": 5}, seed=1, steps=steps)
        data = tr.highway_frame(env_t)
        np.testing.assert_array_equal(data["x"], np.asarray(env_j.state.x))
        np.testing.assert_array_equal(data["lane"], np.asarray(env_j.state.lane))
        assert data["crashed"] == bool(env_j.state.crashed)
        np.testing.assert_array_equal(tr.HighwayRenderer().render(env_t),
                                      jr.HighwayRenderer().render(env_j))
    assert isinstance(tr.renderer_for(env_t), tr.HighwayRenderer)
    assert tr.renderer_for(torch_cartpole.make({}, device="cpu")).frame_data is tr.cartpole_frame


def test_episode_recorder_writes_a_gif(tmp_path):
    env_t = torch_cartpole.make({}, device="cpu")
    recorder = tr.EpisodeRecorder(tmp_path)
    for _ in range(3):
        env_t.step(1)
        recorder.capture(env_t)
    assert len(recorder.frames) == 3
    path = recorder.save(4)
    assert path == tmp_path / "episode-4.gif" and path.stat().st_size > 0
    assert recorder.frames == [] and recorder.save(5) is None


def test_vi_q_table_heatmap():
    from rl_agents_torch.agents.dynamic_programming.value_iteration import (
        ValueIterationAgent as TorchVI,
    )
    from rl_agents_torch.envs.finite_mdp import make as torch_make_mdp
    from rl_agents_tpu.agents.dynamic_programming.value_iteration import (
        ValueIterationAgent as JaxVI,
    )
    from rl_agents_tpu.envs.finite_mdp import make as jax_make_mdp

    agent_j = JaxVI(jax_make_mdp(dict(LOOP_MDP)), {"gamma": 0.9})
    agent_t = TorchVI(torch_make_mdp(dict(LOOP_MDP), device="cpu"), {"gamma": 0.9}, device="cpu")
    q = tg.ValueIterationGraphics.q_table(agent_t)
    np.testing.assert_allclose(q, np.asarray(agent_j.state_action_value), atol=1e-6)
    arrays = [np.asarray(g.display(a).axes[0].collections[0].get_array()).ravel()
              for g, a in ((tg.ValueIterationGraphics, agent_t),
                           (jg.ValueIterationGraphics, agent_j))]
    np.testing.assert_array_equal(arrays[0], q.T.ravel())
    np.testing.assert_allclose(arrays[0], arrays[1], atol=1e-6)
    assert tg.AgentGraphics.display(agent_t) is not None


def test_bftq_frontier_points_match_jax():
    from rl_agents_torch.factory import load_agent as torch_load_agent
    from rl_agents_torch.factory import load_environment as torch_load_environment
    from rl_agents_tpu.agents.budgeted_ftq.agent import BFTQAgent as JaxBFTQ
    from rl_agents_tpu.factory import load_environment as jax_load_environment
    config = {"network": {"beta_encoder_type": "LINEAR", "size_beta_encoder": 3,
                          "activation_type": "RELU", "layers": [16, 16]},
              "betas_for_discretisation": "np.linspace(0, 1, 21)"}
    env_j = jax_load_environment(CONFIGS / "TwoWayEnv" / "env.json")
    env_t = torch_load_environment(CONFIGS / "TwoWayEnv" / "env.json", device="cpu")
    agent_j = JaxBFTQ(env_j, dict(config))
    agent_t = torch_load_agent(dict(config, __class__="BFTQAgent"), env_t, device="cpu")
    for agent in (agent_j, agent_t):
        agent.reset()
    flax_params_to_torch(agent_t.bftq.network, jax.tree.map(np.asarray, agent_j.bftq.params))
    agent_t.bftq.reset_network({k: v.detach().clone()
                                for k, v in agent_t.bftq.network.named_parameters()})
    state = np.asarray(env_j.reset(seed=2)[0])
    with jax.disable_jit():
        fig_j = jg.BFTQGraphics.display_frontier(agent_j, state)
    points = tg.BFTQGraphics.frontier_points(agent_t, state)
    ax_j = fig_j.axes[0]
    cloud = np.asarray(ax_j.collections[0].get_offsets())
    np.testing.assert_allclose(points["qc"], cloud[:, 0], atol=1e-6)
    np.testing.assert_allclose(points["qr"], cloud[:, 1], atol=1e-6)
    line = ax_j.lines[0]
    assert len(points["frontier_qc"]) == len(line.get_xdata()) >= 2
    np.testing.assert_allclose(points["frontier_qc"], line.get_xdata(), atol=1e-6)
    np.testing.assert_allclose(points["frontier_qr"], line.get_ydata(), atol=1e-6)
    fig_t = tg.BFTQGraphics.display_frontier(agent_t, state)
    np.testing.assert_array_equal(fig_t.axes[0].lines[0].get_xdata(), points["frontier_qc"])


def _jax_tree_agent(name):
    from rl_agents_tpu.factory import agent_factory

    config = {"mcts": {"__class__": "MCTSAgent", "budget": 40, "horizon": 4},
              "olop": {"__class__": "OLOPAgent", "budget": 40, "gamma": 0.8}}[name]
    env_j, _ = _synced_cartpole(seed=5)
    agent = agent_factory(env_j, config)
    agent.seed(1)
    agent.plan(np.asarray(env_j.obs))
    return agent


@pytest.mark.parametrize("name", ["mcts", "olop"])
def test_tree_plot_draws_jax_lines_on_a_carried_arena(name):
    """An arena that JAX's agent planned, carried over as a batch of one:
    ``TreePlot.edges`` is what JAX's ``TreePlot.plot`` draws, line by line
    (coordinates and colours), and the port's ``plot`` draws the same."""
    from rl_agents_torch.agents.tree_search.mcts import MCTSTree
    from rl_agents_torch.agents.tree_search.olop import OLOPTree

    tree_j = _jax_tree_agent(name).last_plan_data
    cls = {"mcts": MCTSTree, "olop": OLOPTree}[name]
    tree_t = tree_from_numpy(cls, jax.tree.map(np.asarray, tree_j), device="cpu", batched=False)
    fig_j, ax_j = plt.subplots()
    jtp.TreePlot(tree_j).plot(ax_j)
    edges = TreePlot(tree_t).edges()
    assert len(edges) == len(ax_j.lines) > 4
    fig_t, ax_t = plt.subplots()
    TreePlot(tree_t).plot(ax_t)
    for (x0, y0, x1, y1, value), line_j, line_t in zip(edges, ax_j.lines, ax_t.lines):
        np.testing.assert_array_equal(line_j.get_xdata(), [x0, x1])
        np.testing.assert_array_equal(line_j.get_ydata(), [y0, y1])
        np.testing.assert_array_equal(line_t.get_xydata(), line_j.get_xydata())
        assert line_t.get_color() == line_j.get_color()
    assert len({e[4] for e in edges}) > 1
    plt.close(fig_j)
    plt.close(fig_t)
    assert TreePlot(tree_t).plot_to_writer(None) is not None


def test_tree_row_takes_one_tree_of_a_batch():
    from rl_agents_torch.agents.tree_search.mcts import MCTSTree

    tree = MCTSTree(parent=torch.arange(6).reshape(2, 3), children=torch.zeros(2, 3, 2),
                    count=torch.ones(2, 3, dtype=torch.int64), value=torch.rand(2, 3),
                    prior=torch.ones(2, 3), used=torch.tensor([3, 5]))
    row = tree_row(tree, 1)
    assert row.parent.tolist() == [3, 4, 5] and row.parent.dtype == np.int32
    assert row.children.shape == (3, 2) and int(row.used) == 5
    np.testing.assert_array_equal(row.value, tree.value[1].numpy())


def test_reward_viewer_draws_jaxs_curves():
    viewer_t, viewer_j = RewardViewer(), jtg.RewardViewer()
    for reward in np.random.default_rng(0).normal(size=35):
        viewer_t.update(float(reward))
        viewer_j.update(float(reward))
    lines = [plt.figure(num="Rewards").axes[0].lines]
    assert viewer_t.rewards == viewer_j.rewards
    means = np.convolve(viewer_j.rewards, np.ones(30) / 30, mode="valid")
    np.testing.assert_array_equal(viewer_t.mean_curve(), means)
    np.testing.assert_array_equal(lines[0][1].get_ydata(), means)
    plt.close("all")


def test_display_tree_plots_each_plan_to_the_writer():
    """``display_tree``: the tree agent's ``plan`` plots tree 0 of its last
    plan to its writer, the step count as the epoch, as the JAX agent's
    ``write_tree`` does."""
    from rl_agents_torch.factory import agent_factory

    class Writer:
        def __init__(self):
            self.figures = []

        def add_figure(self, tag, fig, epoch):
            self.figures.append((tag, epoch, len(fig.axes[0].lines)))

    env_t = torch_cartpole.make({}, device="cpu")
    agent = agent_factory(env_t, {"__class__": "MCTSAgent", "budget": 20, "horizon": 3,
                                  "display_tree": True}, device="cpu")
    agent.set_writer(Writer())
    agent.seed(0)
    for _ in range(2):
        agent.act(None)
    assert [(tag, epoch) for tag, epoch, _ in agent.writer.figures] == \
        [("planner/tree", 1), ("planner/tree", 2)]
    assert all(lines == len(TreePlot(agent.last_plan_data).edges()) > 0
               for _, _, lines in agent.writer.figures[1:])
    quiet = agent_factory(env_t, {"__class__": "MCTSAgent", "budget": 20, "horizon": 3},
                          device="cpu")
    quiet.set_writer(Writer())
    quiet.act(None)
    assert quiet.writer.figures == []
