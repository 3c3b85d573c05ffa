"""Robust-agent comparison study.

Port of ``scripts/planners_robust_evaluation.py`` (reference:
scripts/planners_robust_evaluation.py): compare a nominal planner, the robust
planner (DROP) and the oracle on an uncertain environment, accumulating
per-seed returns into ``results.csv`` (agent,environment,mean_return,
std_return).

``--study merge`` runs the reference's robust-control benchmark shape
(scripts/configs/MergeEnv/benchmark_robust_control.json): the
assume-aggressive / assume-defensive nominal MCTS planners and the
DiscreteRobustPlanner (aggressive+defensive ensemble via the
change_vehicles preprocessor) against both traffic-behavior environments.

Usage:
  python -m rl_agents_torch.scripts.planners_robust_evaluation
      [--study toy|merge] [--seeds N] [--budget N] [--horizon N] [--out DIR]
      [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the run fails when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from rl_agents_torch.factory import load_agent, load_agent_config, load_environment

SCRIPTS = Path(__file__).resolve().parent.parent.parent / "scripts"


def run_episode(env, agent, seed, horizon=20):
    agent.seed(seed)
    obs, _ = env.reset(seed=seed)
    total, done, trunc, steps = 0.0, False, False, 0
    while not (done or trunc) and steps < horizon:
        action = agent.act(obs)
        obs, r, done, trunc, _ = env.step(action)
        total += r
        steps += 1
    return total


def toy_study(args):
    env_config = {"id": "finite-mdp", "mode": "deterministic",
                  "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
                  "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
                  "terminal": [0, 0, 0, 0], "max_episode_steps": 50}
    budget = args.budget or 60
    agents = {
        "nominal": {"__class__": "DeterministicPlannerAgent",
                    "budget": budget, "gamma": 0.9},
        "DROP": {"__class__": "DiscreteRobustPlannerAgent",
                 "budget": budget, "gamma": 0.9, "models": []},
    }
    for name, config in agents.items():
        for seed in range(args.seeds):
            yield name, "loop-mdp", config, env_config, seed


def merge_study(args):
    """The reference MergeEnv robust-control benchmark pairs
    (reference: scripts/configs/MergeEnv/benchmark_robust_control.json)."""
    bench = json.loads((SCRIPTS / "configs" / "MergeEnv" / "benchmark_robust_control.json")
                       .read_text())
    env_paths = list(dict.fromkeys(bench["environments"]))
    agent_paths = list(dict.fromkeys(bench["agents"]))
    # the shipped benchmark references DiscreteRobustPlannerAgent/agg_def.json
    # but the corpus directory is DiscreteRobustMCTSAgent/ (upstream path rot)
    agent_paths = [p if (SCRIPTS / p).is_file()
                   else p.replace("DiscreteRobustPlannerAgent", "DiscreteRobustMCTSAgent")
                   for p in agent_paths]
    for env_path in env_paths:
        for agent_path in agent_paths:
            env_config = json.loads((SCRIPTS / env_path).read_text())
            agent_config = load_agent_config(SCRIPTS / agent_path)
            if args.budget is not None:  # default: the corpus's own budgets
                agent_config["budget"] = args.budget
            for seed in range(args.seeds):
                yield Path(agent_path).stem, Path(env_path).stem, agent_config, env_config, seed


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--study", default="toy", choices=("toy", "merge"))
    parser.add_argument("--seeds", type=int, default=5)
    # None keeps each corpus agent's own budget in --study merge
    parser.add_argument("--budget", type=int, default=None)
    parser.add_argument("--horizon", type=int, default=20)
    parser.add_argument("--out", default="out/robust")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    runs = {}
    study = merge_study(args) if args.study == "merge" else toy_study(args)
    for name, env_name, agent_config, env_config, seed in study:
        env = load_environment(dict(env_config), device=args.device)
        agent = load_agent(json.loads(json.dumps(agent_config)), env, device=args.device)
        ret = run_episode(env, agent, seed, horizon=args.horizon)
        runs.setdefault((name, env_name), []).append(ret)

    with open(out / "results.csv", "w") as f:
        f.write("agent,environment,mean_return,std_return\n")
        for (name, env_name), returns in runs.items():
            mean, std = np.mean(returns), np.std(returns)
            print(f"{name:20s} on {env_name:10s}: return {mean:.2f} +- {std:.2f}")
            f.write(f"{name},{env_name},{mean},{std}\n")
    print(f"Wrote {out / 'results.csv'}")
    return runs


if __name__ == "__main__":
    main()
