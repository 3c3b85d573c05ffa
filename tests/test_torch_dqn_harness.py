"""DQN training through the PyTorch port's harness and CLI, on the CPU:
``Evaluation(training=True).train()`` records every step, checkpoints on the
cubic schedule and at the end, and ``recover`` reloads the saved model."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rl_agents_torch.factory import load_agent, load_agent_config, load_environment
from rl_agents_torch.trainer.evaluation import Evaluation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "scripts" / "configs"


def _cartpole_agent_config():
    config = load_agent_config(CONFIGS / "CartPoleEnv" / "DQNAgent.json")
    config["model"]["layers"] = [32, 32]
    config["batch_size"] = 32  # learning starts within three short episodes
    return config


def test_train_writes_checkpoints_and_recover_reloads_them(tmp_path):
    env = load_environment(CONFIGS / "CartPoleEnv" / "env.json", device="cpu")
    agent = load_agent(_cartpole_agent_config(), env, device="cpu")
    evaluation = Evaluation(env, agent, directory=tmp_path, num_episodes=3, training=True,
                            sim_seed=0)
    evaluation.train()
    steps = sum(1 for _ in (evaluation.run_directory / "episodes.jsonl").open())
    assert steps == 3 and len(evaluation.episode_rewards) == 3
    # one SGD step per recorded transition once the memory holds a batch
    total = int(sum(evaluation.episode_rewards))
    assert agent.steps == total - agent.config["batch_size"] + 1
    for name in ("checkpoint-0.tar", "checkpoint-1.tar", "checkpoint-final.tar"):
        assert (evaluation.run_directory / name).is_file()
    latest = tmp_path / "saved_models" / "latest.tar"
    assert latest.is_file()

    fresh = load_agent(_cartpole_agent_config(), env, device="cpu")
    assert not torch.equal(fresh.train_state.params["Dense_0.weight"],
                           agent.train_state.params["Dense_0.weight"])
    recovered = Evaluation(env, fresh, directory=tmp_path, num_episodes=1, sim_seed=0,
                           recover=True)
    for key, value in agent.train_state.params.items():
        assert torch.equal(fresh.train_state.params[key], value)
    recovered.test()
    assert len(recovered.episode_rewards) == 1

    other = load_agent(_cartpole_agent_config(), env, device="cpu")
    Evaluation(env, other, directory=tmp_path, num_episodes=1, sim_seed=0,
               recover=str(evaluation.run_directory / "checkpoint-0.tar"))
    assert not torch.equal(other.train_state.params["Dense_0.weight"],
                           agent.train_state.params["Dense_0.weight"])


def test_cli_trains_on_the_cpu(tmp_path):
    agent_path = tmp_path / "agent.json"
    agent_path.write_text(
        '{"base_config": "%s", "model": {"type": "MultiLayerPerceptron", "layers": [32, 32]}}'
        % (CONFIGS / "CartPoleEnv" / "DQNAgent.json").as_posix())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    command = [sys.executable, "-m", "rl_agents_torch.experiments", "evaluate",
               str(CONFIGS / "CartPoleEnv" / "env.json"), str(agent_path), "--train",
               "--episodes", "2", "--device", "cpu", "--directory", str(tmp_path / "out"),
               "--seed", "1"]
    proc = subprocess.run(command, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Episode rewards:" in proc.stdout
    assert (tmp_path / "out" / "saved_models" / "latest.tar").is_file()
    assert list((tmp_path / "out").glob("run_*/checkpoint-final.tar"))
    proc = subprocess.run(command[:6] + ["--test", "--recover"] + command[7:], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Loaded DQNAgent model" in proc.stderr


def test_cli_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "rl_agents_torch.experiments", "evaluate",
                           str(CONFIGS / "CartPoleEnv" / "env.json"),
                           str(CONFIGS / "CartPoleEnv" / "DQNAgent.json"), "--train",
                           "--episodes", "1"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_one_ego_attention_episode_on_highway(tmp_path):
    env = load_environment({"id": "highway", "vehicles_count": 6, "lanes_count": 4,
                            "duration": 12}, device="cpu")
    config = load_agent_config(CONFIGS / "HighwayEnv" / "agents" / "DQNAgent" /
                               "ego_attention.json")
    config["batch_size"] = 4
    agent = load_agent(config, env, device="cpu")
    assert type(agent.model).__name__ == "EgoAttentionNetwork"
    evaluation = Evaluation(env, agent, directory=tmp_path, num_episodes=1, training=True,
                            sim_seed=0)
    evaluation.train()
    length = int(evaluation.run_directory.joinpath("episodes.jsonl").read_text()
                 .split('"length": ')[1].split(",")[0])
    assert agent.steps == length - 3 > 0
    assert (evaluation.run_directory / "checkpoint-final.tar").is_file()
    values = agent.get_state_action_values(env.reset(seed=1)[0])
    assert values.shape == (5,) and np.all(np.isfinite(values))
