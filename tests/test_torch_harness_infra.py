"""The harness's infrastructure in the port against the JAX package's:
seeding, the metrics writers, the logger, the phase timer and the trace,
the state samplers, ``Evaluation``'s run directory, step callback,
``close_env``, ``save_agent_model(do_save=)`` and display arguments, and the
CLI's ``benchmark`` command and ``evaluate`` flags."""
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rl_agents_torch.trainer.state_sampler as torch_samplers
import rl_agents_tpu.trainer.state_sampler as jax_samplers
from rl_agents_torch import experiments
from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.trainer import logger as torch_logger
from rl_agents_torch.trainer.evaluation import Evaluation
from rl_agents_torch.trainer.metrics import JsonlWriter, NullWriter
from rl_agents_torch.trainer.profiling import PhaseTimer, device_memory_stats, trace
from rl_agents_torch.utils.seeding import np_random
from rl_agents_tpu.trainer import logger as jax_logger
from rl_agents_tpu.trainer.metrics import JsonlWriter as JaxJsonlWriter
from rl_agents_tpu.trainer.profiling import PhaseTimer as JaxPhaseTimer
from rl_agents_tpu.utils.seeding import np_random as jax_np_random

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "scripts" / "configs"


@pytest.fixture(autouse=True)
def _keep_the_root_logger():
    """The CLI and the logger configure the root logger: put it back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for handler in root.handlers:
        if handler not in handlers:
            handler.close()
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.mark.parametrize("seed", [None, 0, 7, 2**40])
def test_np_random_is_jaxs_stream(seed):
    rng, entropy = np_random(seed)
    rng_j, entropy_j = jax_np_random(seed)
    if seed is not None:
        assert entropy == entropy_j == seed
        np.testing.assert_array_equal(rng.random(16), rng_j.random(16))
    with pytest.raises(ValueError):
        np_random(-1)


def test_writers_match_jaxs(tmp_path):
    writer, writer_j = JsonlWriter(tmp_path / "torch"), JaxJsonlWriter(tmp_path / "jax")
    for w in (writer, writer_j):
        w.add_scalar("episode/return", np.float32(1.5), 3)
        w.add_scalar("time/x_mean_s", 2, None)
        w.add_histogram("h", [1, 2], 0)
        w.add_image("i", None)
        w.add_figure("f", None)
        w.close()
    assert (tmp_path / "torch" / "metrics.jsonl").read_text() \
        == (tmp_path / "jax" / "metrics.jsonl").read_text()
    null = NullWriter()
    for method in ("add_scalar", "add_histogram", "add_image", "add_figure"):
        assert getattr(null, method)("tag", 1.0, 0) is None
    null.close()


def test_phase_timer_writes_jaxs_scalars(tmp_path, monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    for module in ("rl_agents_torch.trainer.profiling", "rl_agents_tpu.trainer.profiling"):
        monkeypatch.setattr(f"{module}.time.perf_counter", lambda: float(next(ticks)))
    lines = []
    for cls, writer_cls, name in ((PhaseTimer, JsonlWriter, "torch"),
                                  (JaxPhaseTimer, JaxJsonlWriter, "jax")):
        writer = writer_cls(tmp_path / name)
        timer = cls(writer)
        for phase in ("collect", "update", "collect"):
            with timer.phase(phase):
                pass
        assert timer.mean("collect") == 0.25 and timer.counts["collect"] == 2
        timer.flush(5)
        writer.close()
        lines.append((tmp_path / name / "metrics.jsonl").read_text().splitlines())
    assert lines[0] == lines[1]
    assert [json.loads(x)["tag"] for x in lines[0]] == [
        "time/collect_mean_s", "time/collect_total_s", "time/update_mean_s",
        "time/update_total_s"]


def test_trace_writes_a_chrome_trace_and_memory_stats_need_a_card(tmp_path):
    with trace(tmp_path / "trace") as prof:
        torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["traceEvents"] and prof is not None
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_logger_writes_jaxs_lines(tmp_path):
    root = logging.getLogger()
    for module, name in ((torch_logger, "torch"), (jax_logger, "jax")):
        module.configure(default_level="DEBUG")
        before = set(root.handlers)
        module.add_file_handler(tmp_path / name / "run.log")
        (handler,) = set(root.handlers) - before
        logging.getLogger("some.module").debug("step %d", 3)
        logging.getLogger("some.module").info("done")
        root.removeHandler(handler)
        handler.close()
    assert (tmp_path / "torch" / "run.log").read_text() \
        == (tmp_path / "jax" / "run.log").read_text() \
        == "[some.module:DEBUG] step 3 \n[some.module:INFO] done \n"
    torch_logger.configure()
    assert logging.getLogger("torch").level == logging.WARNING
    torch_logger.configure(json.loads((CONFIGS / "verbose.json").read_text()))
    assert root.handlers[0].level == logging.DEBUG


@pytest.mark.parametrize("name", ["CartPoleStateSampler", "MountainCarStateSampler",
                                  "ObstacleStateSampler"])
def test_state_samplers_equal_jaxs(name):
    ours, theirs = getattr(torch_samplers, name)(7), getattr(jax_samplers, name)(7)
    for a, b in zip(ours.states_mesh(), theirs.states_mesh()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.states_list(), theirs.states_list())


def _cartpole_agent(steps=12):
    env = load_environment({"id": "cartpole", "max_episode_steps": steps}, device="cpu")
    return env, load_agent({"__class__": "RandomUniformAgent"}, env, device="cpu")


def test_evaluation_arguments(tmp_path):
    env, agent = _cartpole_agent()
    calls = []

    def callback(episode, env_, agent_, transition, writer):
        assert env_ is env and agent_ is agent and writer is evaluation.writer
        calls.append((episode, len(transition)))

    closed = []
    env.close = lambda: closed.append(True)
    evaluation = Evaluation(env, agent, directory=tmp_path, run_directory="named",
                            num_episodes=2, sim_seed=0, close_env=False,
                            step_callback_fn=callback)
    assert evaluation.run_directory == tmp_path / "named"
    evaluation.test()
    lengths = [json.loads(x)["length"] for x in
               (tmp_path / "named" / Evaluation.EPISODES_FILE).read_text().splitlines()]
    assert [c[0] for c in calls] == [0] * lengths[0] + [1] * lengths[1]
    assert {c[1] for c in calls} == {7} and not closed
    assert evaluation.save_agent_model("x", do_save=False) is None
    assert not (tmp_path / "named" / "checkpoint-x.tar").exists()
    Evaluation(env, agent, directory=tmp_path, num_episodes=1, sim_seed=0).test()
    assert closed == [True]


@pytest.mark.parametrize("flag", ["display_env", "display_agent", "display_rewards"])
def test_display_arguments_name_the_slice_that_ports_them(flag, tmp_path, monkeypatch):
    """Each display flag builds what it names, as in the JAX harness:
    ``display_env`` the episode recorder and the live viewer,
    ``display_agent`` (with ``display_env``) the viewer's agent overlay,
    ``display_rewards`` the reward viewer; the CLI's ``--no-display`` turns
    ``display_env`` off."""
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    env, agent = _cartpole_agent(steps=3)
    kwargs = {flag: True}
    if flag == "display_agent":
        kwargs["display_env"] = True
    evaluation = Evaluation(env, agent, directory=tmp_path, num_episodes=1, sim_seed=0,
                            **kwargs)
    built = {"recorder": evaluation.recorder is not None,
             "viewer": evaluation.viewer is not None,
             "overlay": evaluation.viewer is not None
             and evaluation.viewer.agent_display is not None,
             "reward_viewer": evaluation.reward_viewer is not None}
    want = {"display_env": {"recorder", "viewer"},
            "display_agent": {"recorder", "viewer", "overlay"},
            "display_rewards": {"reward_viewer"}}[flag]
    assert {k for k, v in built.items() if v} == want
    evaluation.test()
    if flag == "display_rewards":
        assert evaluation.reward_viewer.rewards == evaluation.episode_rewards == [3.0]
    else:  # the test episode was recorded
        assert list(evaluation.run_directory.glob("episode-0.gif"))

    class Built(Exception):
        pass

    displayed = []

    def build(*args, **kwargs):
        displayed.append(kwargs["display_env"])
        raise Built

    monkeypatch.setattr(experiments, "Evaluation", build)
    for extra in ([], ["--no-display"]):
        args = experiments.build_parser().parse_args(
            ["evaluate", "env.json", "agent.json", "--test", "--device", "cpu"] + extra)
        with pytest.raises(Built):
            experiments.evaluate({"id": "cartpole"}, {"__class__": "RandomUniformAgent"}, args)
    assert displayed == [True, False]


def test_generate_agent_configs_equals_jaxs(tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    from experiments import generate_agent_configs as jax_generate

    base = tmp_path / "base.json"
    base.write_text(json.dumps({"__class__": "MCTSAgent", "budget": 100,
                                "exploration": {"tau": 1}}))
    benchmark = {"agents": [{"base_agent": str(base),
                             "sweep": {"budget": [50, 100], "exploration/tau": [1, 2]}},
                            str(base)]}
    agents = experiments.generate_agent_configs(benchmark)
    assert agents == jax_generate(benchmark) and len(agents) == 5
    assert sorted(a["budget"] for a in agents if isinstance(a, dict)) == [50, 50, 100, 100]


def test_cli_benchmark_runs_every_pair(tmp_path, capsys):
    experiments.main(["benchmark", str(CONFIGS / "FiniteMDPEnv" / "anti_vi" / "benchmark.json"),
                      "--episodes", "1", "--device", "cpu", "--directory", str(tmp_path)])
    summaries = list(tmp_path.glob("benchmark_summary.*.json"))
    assert len(summaries) == 1
    runs = json.loads(summaries[0].read_text())
    assert len(runs) == 4 and len(set(runs)) == 4
    for run in runs:
        episodes = (Path(run) / Evaluation.EPISODES_FILE).read_text().splitlines()
        assert len(episodes) == 1 and np.isfinite(json.loads(episodes[0])["total_reward"])
    assert "Running 4 experiments (2 environments x 2 agents)" in capsys.readouterr().out


def test_cli_evaluate_flags(tmp_path, capsys):
    anti_vi = CONFIGS / "FiniteMDPEnv" / "anti_vi"
    experiments.main(["evaluate", str(anti_vi / "env_1.json"),
                      str(anti_vi / "agents" / "robust_value_iteration.json"), "--test",
                      "--episodes", "1", "--seed", "0", "--repeat", "2", "--name-from-config",
                      "--no-display", "--verbose", "--device", "cpu",
                      "--directory", str(tmp_path)])
    runs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir() and p.name != "saved_models")
    assert len(runs) >= 1 and all(r.startswith("robust_value_iteration_") for r in runs)
    assert capsys.readouterr().out.count("Run directory:") == 2
    assert logging.getLogger().handlers[0].level == logging.DEBUG
