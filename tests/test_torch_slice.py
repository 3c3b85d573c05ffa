"""The ported slice as a whole: config corpus -> factory -> agent -> env,
stepped in lockstep with the JAX package, and the port's CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rl_agents_torch import factory as torch_factory
from rl_agents_torch.convert import from_numpy
from rl_agents_torch.envs.cartpole import CartPoleState
from rl_agents_torch.experiments import main as torch_experiments_main
from rl_agents_torch.trainer.evaluation import Evaluation as TorchEvaluation
from rl_agents_tpu import factory as jax_factory
from rl_agents_tpu.trainer.evaluation import Evaluation as JaxEvaluation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "scripts" / "configs"
AGENT = {"__class__": "OLOPAgent", "budget": 40, "gamma": 0.95}


def test_cartpole_lockstep_through_the_factory():
    env_j = jax_factory.load_environment(CONFIGS / "CartPoleEnv" / "env.json")
    env_t = torch_factory.load_environment(CONFIGS / "CartPoleEnv" / "env.json", device="cpu")
    obs_j, _ = env_j.reset(seed=7)
    env_t.reset(seed=7)
    # seeded resets differ between jax.random and torch.Generator: carry the state
    env_t.state = from_numpy(CartPoleState, {k: np.asarray(v)[None] for k, v in
                                             env_j.state._asdict().items()}, device="cpu")
    obs_t = env_t.functional.observe(env_t.params, env_t.state)[0].numpy()
    agent_j = jax_factory.load_agent(dict(AGENT), env_j)
    agent_t = torch_factory.load_agent(dict(AGENT), env_t, device="cpu")
    for _ in range(15):
        action_j, action_t = agent_j.act(obs_j), agent_t.act(obs_t)
        assert action_t == action_j
        obs_j, reward_j, term_j, trunc_j, _ = env_j.step(action_j)
        obs_t, reward_t, term_t, trunc_t, _ = env_t.step(action_t)
        np.testing.assert_allclose(obs_t, np.asarray(obs_j), atol=1e-5)
        assert (reward_t, term_t, trunc_t) == (reward_j, term_j, trunc_j)
        assert int(env_t.state.t[0]) == int(env_j.state.t)


def test_loop_mdp_test_episode_matches_the_jax_harness(tmp_path):
    env_config = CONFIGS / "FiniteMDPEnv" / "env_loop.json"
    agent_config = CONFIGS / "FiniteMDPEnv" / "OLOPAgent.json"
    rewards = []
    for factory, kwargs, evaluation in [
            (jax_factory, {}, JaxEvaluation), (torch_factory, {"device": "cpu"}, TorchEvaluation)]:
        env = factory.load_environment(env_config, **kwargs)
        agent = factory.load_agent(agent_config, env, **kwargs)
        run = evaluation(env, agent, directory=tmp_path / agent.__module__.split(".")[0],
                         num_episodes=1, training=False, sim_seed=0)
        run.test()
        rewards.append(run.episode_rewards)
    assert rewards[1] == rewards[0]
    assert len(rewards[1]) == 1 and rewards[1][0] > 0


def test_cli_evaluates_on_the_cpu(tmp_path):
    env_path = tmp_path / "env.json"
    env_path.write_text(json.dumps({"id": "cartpole", "max_episode_steps": 10}))
    agent_path = tmp_path / "agent.json"
    agent_path.write_text(json.dumps(AGENT))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "rl_agents_torch.experiments", "evaluate", str(env_path),
         str(agent_path), "--test", "--episodes", "1", "--seed", "0", "--device", "cpu",
         "--directory", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    runs = list(out.glob("run_*"))
    assert len(runs) == 1 and list(runs[0].glob("metadata.*.json"))
    episodes = [json.loads(line) for line in (runs[0] / "episodes.jsonl").read_text().splitlines()]
    assert len(episodes) == 1 and episodes[0]["length"] == 10
    assert episodes[0]["total_reward"] == 10.0
    assert "Episode rewards: [10.0]" in proc.stdout


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    env_path = tmp_path / "env.json"
    env_path.write_text(json.dumps({"id": "cartpole"}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_experiments_main(["evaluate", str(env_path), str(env_path), "--test"])


@pytest.mark.parametrize("env_config,agent_config,steps", [
    ({"id": "cartpole", "max_episode_steps": 4},
     {"__class__": "MCTSAgent", "budget": 60, "temperature": 200, "gamma": 0.95}, 4),
    ({"id": "finite-mdp", "generator": "garnet", "num_states": 16, "num_actions": 4,
      "branching": 2, "seed": 0, "max_episode_steps": 3},
     {"__class__": "<class 'rl_agents.agents.tree_search.mdp_gape.MDPGapEAgent'>", "gamma": 0.7,
      "budget": 30, "accuracy": 0.0, "confidence": 1.0, "max_next_states_count": 2}, 3),
])
def test_cli_runs_the_new_agents_on_the_cpu(tmp_path, env_config, agent_config, steps):
    """The corpus configs ``CartPoleEnv/MCTSAgent.json`` and
    ``FiniteMDPEnv/agents/mdp-gape.json``, cut to a short episode and a small
    budget, through ``python -m rl_agents_torch.experiments``."""
    env_path, agent_path, out = tmp_path / "env.json", tmp_path / "agent.json", tmp_path / "out"
    env_path.write_text(json.dumps(env_config))
    agent_path.write_text(json.dumps(agent_config))
    proc = subprocess.run(
        [sys.executable, "-m", "rl_agents_torch.experiments", "evaluate", str(env_path),
         str(agent_path), "--test", "--episodes", "1", "--seed", "0", "--device", "cpu",
         "--directory", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    runs = list(out.glob("run_*"))
    assert len(runs) == 1
    episodes = [json.loads(line) for line in (runs[0] / "episodes.jsonl").read_text().splitlines()]
    assert len(episodes) == 1 and episodes[0]["length"] == steps
    assert np.isfinite(episodes[0]["total_reward"])


def test_corpus_configs_load_for_both_new_agents():
    env = torch_factory.load_environment(CONFIGS / "CartPoleEnv" / "env.json", device="cpu")
    agent = torch_factory.load_agent(CONFIGS / "CartPoleEnv" / "MCTSAgent.json", env, device="cpu")
    assert (agent.config["episodes"], agent.config["horizon"]) == (14, 26)
    assert agent.config["temperature"] == 200
    env = torch_factory.load_environment(CONFIGS / "FiniteMDPEnv" / "env_garnet.json",
                                         device="cpu")
    agent = torch_factory.load_agent(CONFIGS / "FiniteMDPEnv" / "agents" / "mdp-gape.json", env,
                                     device="cpu")
    assert (agent.config["episodes"], agent.config["horizon"]) == (20, 5)


SAILING = CONFIGS / "SailingEnv"


@pytest.mark.parametrize("agent_file", ["gbop.json", "gbop-d.json", "opd.json"])
def test_cli_runs_the_sailing_planner_study_on_the_cpu(tmp_path, agent_file):
    """``SailingEnv/env.json`` with ``agents/{gbop,gbop-d,opd}.json`` through
    ``python -m rl_agents_torch.experiments``: the corpus's agent configs as
    they are, the env config with its episode cut to a few steps (the config's
    own episode is 160 steps of a planner at budget 200)."""
    steps = 3
    env_config = json.loads((SAILING / "env.json").read_text())
    env_config["max_episode_steps"] = steps
    env_path, out = tmp_path / "env.json", tmp_path / "out"
    env_path.write_text(json.dumps(env_config))
    proc = subprocess.run(
        [sys.executable, "-m", "rl_agents_torch.experiments", "evaluate", str(env_path),
         str(SAILING / "agents" / agent_file), "--test", "--episodes", "1", "--seed", "0",
         "--device", "cpu", "--directory", str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    runs = list(out.glob("run_*"))
    assert len(runs) == 1
    episodes = [json.loads(line) for line in (runs[0] / "episodes.jsonl").read_text().splitlines()]
    assert len(episodes) == 1 and episodes[0]["length"] == steps
    assert -steps <= episodes[0]["total_reward"] < 0  # three moves away from the start corner


def test_sailing_corpus_configs_load_with_the_sizes_of_the_jax_package():
    env = torch_factory.load_environment(SAILING / "env.json", device="cpu")
    env_j = jax_factory.load_environment(SAILING / "env.json")
    assert env.functional.size == env_j.functional.size == 8
    assert env.functional.max_episode_steps == env_j.functional.max_episode_steps == 160
    gbop = torch_factory.load_agent(SAILING / "agents" / "gbop.json", env, device="cpu")
    gbop_j = jax_factory.load_agent(SAILING / "agents" / "gbop.json", env_j)
    for key in ("episodes", "horizon", "accuracy", "max_next_states_count", "upper_bound"):
        assert gbop.config[key] == gbop_j.config[key], key
    assert (gbop.config["episodes"], gbop.config["horizon"]) == (3, 55)
    for name in ("gbop-d.json", "opd.json"):
        agent = torch_factory.load_agent(SAILING / "agents" / name, env, device="cpu")
        agent_j = jax_factory.load_agent(SAILING / "agents" / name, env_j)
        assert type(agent).__name__ == type(agent_j).__name__
        assert agent.config["budget"] == agent_j.config["budget"] == 200
        assert agent.config["gamma"] == agent_j.config["gamma"] == 0.99
