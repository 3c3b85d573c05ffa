"""The PyTorch port stands alone: no JAX anywhere in it, imports without JAX,
and keeps the CPU path of the KL kernel wrapper away from the CUDA build."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rl_agents_tpu"}
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in (REPO / "rl_agents_torch").rglob("*.py")) + ["chip_smoke.py",
                                                                          "multichip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_port_module_imports_no_jax(relpath):
    found = set(_imported_roots(REPO / relpath)) & FORBIDDEN
    assert not found, f"{relpath} imports {sorted(found)}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'rl_agents_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, rl_agents_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rl_agents_torch.__path__, 'rl_agents_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 99


# the modules of the envs and robust-control slice, each held in the checks above
SLICE_9_MODULES = ("robust/interval.py", "envs/linear.py", "envs/dynamics.py",
                   "envs/gridenv.py", "envs/minigrid.py", "envs/classic.py", "envs/parking.py",
                   "envs/bridge.py", "utils/lmi.py", "agents/control.py",
                   "agents/robust/robust_epc.py", "agents/robust/constrained_epc.py")


# the modules of the distributed learner and harness infrastructure slice
SLICE_10_MODULES = ("utils/seeding.py", "trainer/metrics.py", "trainer/logger.py",
                    "trainer/state_sampler.py", "trainer/profiling.py", "trainer/checkpoint.py",
                    "serving.py", "parallel/distributed.py", "parallel/mesh.py")


def test_the_slice_modules_are_checked():
    assert {f"rl_agents_torch/{m}" for m in SLICE_9_MODULES} <= set(PORT_FILES)


def test_the_slice_10_modules_are_checked():
    assert {f"rl_agents_torch/{m}" for m in SLICE_10_MODULES} <= set(PORT_FILES)


# the modules of the graphics slice, and the study scripts
SLICE_11_MODULES = ("graphics/__init__.py", "graphics/render.py", "graphics/pygame_viewer.py",
                    "graphics/agent_graphics.py", "graphics/robust_graphics.py",
                    "graphics/tree_plot.py", "trainer/graphics.py", "scripts/__init__.py",
                    "scripts/planners_evaluation.py", "scripts/planners_robust_evaluation.py",
                    "scripts/planners_visualization.py")


def test_the_slice_11_modules_are_checked():
    assert {f"rl_agents_torch/{m}" for m in SLICE_11_MODULES} <= set(PORT_FILES)


def test_the_port_has_every_module_of_the_jax_package():
    """The module lists differ only by design: no ``ops/onehot.py`` (direct
    indexing), ``ops/pallas_kl.py`` is ``ops/kl_bound.py``, and the port's
    own additions (among them the highway transition's kernel, which XLA
    fuses in the JAX package, the constrained solve's kernel, which XLA
    compiles there, the build the kernels share, and the capture and replay of
    a planner's episode as one CUDA graph)."""
    def modules(package):
        return {p.relative_to(REPO / package).as_posix()
                for p in (REPO / package).rglob("*.py")}

    jax_modules, port_modules = modules("rl_agents_tpu"), modules("rl_agents_torch")
    assert jax_modules - port_modules == {"ops/onehot.py", "ops/pallas_kl.py"}
    assert port_modules - jax_modules == {
        "convert.py", "experiments.py", "utils/device.py", "utils/noise.py", "ops/kl_bound.py",
        "ops/highway_transition.py", "ops/max_expectation.py", "ops/cuda_build.py",
        "agents/tree_search/episode_graph.py", "scripts/__init__.py",
        "scripts/planners_evaluation.py", "scripts/planners_robust_evaluation.py",
        "scripts/planners_visualization.py"}


def test_the_port_imports_without_matplotlib_or_pygame():
    code = (
        "import sys\n"
        "for name in ('matplotlib', 'pygame'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, rl_agents_torch\n"
        "for m in pkgutil.walk_packages(rl_agents_torch.__path__, 'rl_agents_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rl_agents_torch.trainer.graphics import RewardViewer\n"
        "viewer = RewardViewer()\n"
        "viewer.update(1.0)\n"
        "print(viewer.rewards)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[1.0]"


def test_the_bridge_imports_gymnasium_only_when_a_bridge_is_made():
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import rl_agents_torch.envs.bridge, rl_agents_torch.factory\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_kl_bound_on_cpu_never_touches_the_build(monkeypatch):
    from rl_agents_torch.ops import cuda_build
    from rl_agents_torch.ops import kl_bound as mod
    from rl_agents_torch.trainer.profiling import counters

    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(mod, "build", forbidden)
    monkeypatch.setattr(mod, "_load", forbidden)
    monkeypatch.setattr(cuda_build.subprocess, "run", forbidden)
    before = counters["kl_bound.launches"]
    out = mod.kl_bound(torch.tensor([0.5, 2.0]), torch.tensor([1.0, 4.0]),
                       torch.tensor(np.log(10.0), dtype=torch.float32), device="cpu")
    assert out.device.type == "cpu" and out.shape == (2,)
    assert counters["kl_bound.launches"] == before


def test_kl_bound_refuses_tensors_on_another_device():
    from rl_agents_torch.ops.kl_bound import kl_bound

    with pytest.raises(ValueError, match="expected cpu"):
        kl_bound(torch.zeros(3, device="meta"), 1.0, 1.0, device="cpu")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from rl_agents_torch.agents.tree_search.batch import (
        gbop_plan_batch,
        gbop_stochastic_plan_batch,
        mcts_plan_batch,
        mdp_gape_plan_batch,
        olop_plan_batch,
        opd_plan_batch,
        state_aware_plan_batch,
    )
    from rl_agents_torch.agents.tree_search.deterministic import (
        opd_plan,
        opd_plan_batch_vmap,
        opd_plan_continue,
    )
    from rl_agents_torch.agents.tree_search.mcts import mcts_plan, mcts_plan_continue
    from rl_agents_torch.envs.cartpole import CartPoleEnv
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.ops.hashing import table_init
    from rl_agents_torch.ops.kl_bound import kl_bound
    from rl_agents_torch.utils.math import kl_upper_bound

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_environment({"id": "cartpole"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kl_bound(0.5, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kl_upper_bound(0.5, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_init(8)
    env =load_environment({"id": "cartpole"}, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_agent({"__class__": "OLOPAgent", "budget": 10}, env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        olop_plan_batch(CartPoleEnv(), env.params, env.state, num_actions=2, episodes=1,
                        horizon=1, gamma=0.9, threshold_coeff=4.0)
    for name in ("MCTSAgent", "MDPGapEAgent", "GraphBasedPlannerAgent",
                 "StochasticGraphBasedPlannerAgent", "DeterministicPlannerAgent",
                 "StateAwarePlannerAgent"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_agent({"__class__": name, "budget": 10}, env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_environment({"id": "sailing-v0"})
    probs = torch.ones(2) / 2
    generator = torch.Generator().manual_seed(0)
    mcts_kw = dict(num_actions=2, episodes=1, horizon=1, gamma=0.9, temperature=1.0)
    for planner in (mcts_plan_batch, mcts_plan):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            planner(CartPoleEnv(), env.params, env.state, generator, probs, probs, **mcts_kw)
    tree = mcts_plan(CartPoleEnv(), env.params, env.state, generator, probs, probs,
                     device="cpu", **mcts_kw)[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcts_plan_continue(CartPoleEnv(), env.params, tree, env.state, generator, probs, probs,
                           **mcts_kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mdp_gape_plan_batch(CartPoleEnv(), env.params, env.state, generator, num_actions=2,
                            episodes=1, horizon=1, gamma=0.9, accuracy=0.0, confidence=0.9,
                            transition_threshold_coeff=0.1)
    obs = CartPoleEnv().observe(env.params, env.state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbop_plan_batch(CartPoleEnv(), env.params, env.state, obs, generator, num_actions=2,
                        expansions=1, gamma=0.9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbop_stochastic_plan_batch(CartPoleEnv(), env.params, env.state, obs, generator,
                                   num_actions=2, episodes=1, horizon=1, gamma=0.9, accuracy=0.01,
                                   reward_threshold_coeff=1.0, transition_threshold_coeff=0.1)
    opd_kw = dict(num_actions=2, expansions=1, gamma=0.9)
    for planner in (opd_plan, opd_plan_batch, opd_plan_batch_vmap):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            planner(CartPoleEnv(), env.params, env.state, generator, **opd_kw)
    tree = opd_plan(CartPoleEnv(), env.params, env.state, generator, device="cpu", **opd_kw)[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opd_plan_continue(CartPoleEnv(), env.params, tree, env.state, generator, **opd_kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_aware_plan_batch(CartPoleEnv(), env.params, env.state, obs, generator, **opd_kw)
    from rl_agents_torch.models.optimizers import optimizer_factory
    from rl_agents_torch.models.zoo import MultiLayerPerceptron
    from rl_agents_torch.parallel.actor_learner import make_actor_learner, train_dqn_fused

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_agent({"__class__": "DQNAgent"}, env)
    mdp = load_environment({"id": "finite-mdp"}, device="cpu")
    for config in ({"__class__": "ValueIterationAgent"},
                   {"__class__": "RobustValueIterationAgent", "models": [
                       {"mode": "deterministic", "transition": [[0]], "reward": [[1.0]]}]},
                   {"__class__": "RandomUniformAgent"}, {"__class__": "OpenLoopAgent"},
                   {"__class__": "MCTSWithPriorPolicyAgent", "budget": 10},
                   {"__class__": "FTQAgent"}, {"__class__": "BFTQAgent"},
                   {"__class__": "MCTSDPWAgent"}, {"__class__": "BRUEAgent"},
                   {"__class__": "SparseSamplingAgent"}, {"__class__": "PlaTyPOOSAgent"},
                   {"__class__": "CEMAgent"}, {"__class__": "LatentCEMAgent"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_agent(config, mdp if "Value" in config["__class__"] else env)
    from rl_agents_torch.agents.tree_search.mcts_with_prior import mcts_prior_plan, root_prior

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcts_prior_plan(CartPoleEnv(), env.params, env.state, obs, generator, probs, root_prior,
                        **mcts_kw)
    model = MultiLayerPerceptron(4, (8,), out=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_actor_learner(CartPoleEnv(), model, optimizer_factory("ADAM"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_dqn_fused(CartPoleEnv(), model, total_steps=1, segment=1)
    for env_id in ("gridenv", "lineenv", "dynamics", "mountaincar", "pendulum", "linear-system",
                   "lane-keeping-v0", "parking-v0", "MiniGrid-Empty-16x16-v0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_environment({"id": env_id})
    linear = load_environment({"id": "linear-system"}, device="cpu")
    epc = {"A": [[0.0, 1.0], [0.0, 0.0]], "B": [[0.0], [1.0]], "phi": [[[0.0, 0.0], [0.0, -1.0]]],
           "sub_agent": {"__class__": "DeterministicPlannerAgent", "budget": 4}}
    for config in ({"__class__": "LinearFeedbackAgent"}, {"__class__": "IntervalFeedbackAgent"},
                   dict(epc, __class__="RobustEPCAgent"), dict(epc, __class__="NominalEPCAgent"),
                   dict(epc, __class__="ConstrainedEPCAgent")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_agent(config, linear)
    from rl_agents_torch.robust.interval import make_lpv
    from rl_agents_torch.utils.lmi import interval_lmi_problem, solve_interval_lmi

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_lpv(np.eye(2), np.zeros((1, 2, 2)), np.zeros(2))
    eye = np.eye(2)
    for solve in (interval_lmi_problem, solve_interval_lmi):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve(eye, eye, eye, np.ones((2, 1)))


def test_agents_not_yet_ported_name_what_is_missing():
    from rl_agents_torch.envs.bridge import GymBridge
    from rl_agents_torch.factory import load_agent, load_environment

    env = load_environment({"id": "cartpole"}, device="cpu")
    # the one class that the corpus names and neither package ships
    with pytest.raises(NotImplementedError, match="ModelBiasAgent"):
        load_agent({"__class__": "ModelBiasAgent"}, env, device="cpu")
    # an id that no functional env serves goes to the gymnasium bridge, as in
    # JAX: gymnasium names the missing id
    gym = pytest.importorskip("gymnasium")
    for env_id in ("gridenv-v0", "sailing-8-v0"):
        with pytest.raises(gym.error.Error, match=env_id.split("-v")[0]):
            load_environment({"id": env_id}, device="cpu")
    assert isinstance(load_environment({"id": "CartPole-v1"}, device="cpu"), GymBridge)
    # ported since: the robust planners, the highway family, closed-loop MCTS,
    # BRUE, CEM, the OPD parity planner, the envs and the control agents
    obs = env.reset(seed=0)[0]
    for name in ("DiscreteRobustPlannerAgent", "IntervalRobustPlannerAgent"):
        assert load_agent({"__class__": name, "budget": 6}, env, device="cpu").act(obs) in (0, 1)
    assert load_environment({"id": "highway-v0"}, device="cpu").functional.vehicles == 15
    for config in ({"__class__": "MCTSAgent", "closed_loop": True, "budget": 20},
                   {"__class__": "BRUEAgent", "budget": 20}, {"__class__": "CEMAgent"}):
        assert load_agent(config, env, device="cpu").act(obs) in (0, 1)
    assert load_environment({"id": "parking-v0"}, device="cpu").observation_space.shape == (12,)
    linear = load_environment({"id": "linear-system"}, device="cpu")
    agent = load_agent({"__class__": "RobustEPCAgent", "A": [[0.0, 1.0], [0.0, 0.0]],
                        "B": [[0.0], [1.0]], "phi": [[[0.0, 0.0], [0.0, -1.0]]]}, linear,
                       device="cpu")
    assert agent.act(linear.reset(seed=0)[0]) in (0, 1)
    from rl_agents_torch.agents.tree_search.deterministic import opd_plan_parity
    from rl_agents_torch.utils.pcg64 import pcg64_init

    stream, inc = pcg64_init([0], device="cpu")
    actions, lengths, _, _ = opd_plan_parity(env.functional, env.params, env.state, stream, inc,
                                             num_actions=2, expansions=4, gamma=0.9,
                                             device="cpu")
    assert int(lengths[0]) >= 1 and int(actions[0, 0]) in (0, 1)


def test_the_graph_and_tree_planners_and_sailing_ids_are_registered():
    from rl_agents_torch.factory import AGENT_REGISTRY, ENV_REGISTRY, load_agent, load_environment

    assert {"GraphBasedPlannerAgent", "StochasticGraphBasedPlannerAgent",
            "DeterministicPlannerAgent", "StateAwarePlannerAgent"} <= set(AGENT_REGISTRY)
    assert {"sailing-v0", "sailing-5-v0", "sailing-10-v0", "sailing-20-v0"} <= set(ENV_REGISTRY)
    env = load_environment({"id": "sailing-5-v0"}, device="cpu")
    for name in ("GraphBasedPlannerAgent", "DeterministicPlannerAgent"):
        agent = load_agent({"__class__": name, "budget": 16, "gamma": 0.9}, env, device="cpu")
        assert agent.act(env.reset(seed=0)[0]) in range(8)
