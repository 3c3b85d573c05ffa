"""Experiment CLI of the PyTorch port: evaluate an agent on an environment.

Mirrors the ``evaluate`` command of ``scripts/experiments.py`` (reference:
scripts/experiments.py:1-148):

  python -m rl_agents_torch.experiments evaluate <environment.json> <agent.json>
      (--train|--test) [--episodes N] [--seed S] [--recover | --recover-from PATH]
      [--device cuda|cpu] [--directory D]

``--device`` defaults to ``cuda`` and the run fails when no CUDA device is
present; pass ``--device cpu`` to run on the CPU.
"""
from __future__ import annotations

import argparse
import logging

from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.trainer.evaluation import Evaluation


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    ev = sub.add_parser("evaluate", help="evaluate an agent on an environment")
    ev.add_argument("environment", help="path to an environment JSON config")
    ev.add_argument("agent", help="path to an agent JSON config")
    mode = ev.add_mutually_exclusive_group(required=True)
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--test", action="store_true")
    ev.add_argument("--episodes", type=int, default=5)
    ev.add_argument("--seed", type=int, default=None)
    ev.add_argument("--recover", action="store_true",
                    help="load the model from the latest checkpoint")
    ev.add_argument("--recover-from", type=str, default=None,
                    help="load the model from a given checkpoint path")
    ev.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ev.add_argument("--directory", default=None,
                    help="output directory (default: out/<env id>/<agent class>)")
    return parser


def evaluate(environment_config, agent_config, args):
    """Set up and run one evaluation (reference: experiments.py:43-82);
    return its run directory."""
    env = load_environment(environment_config, device=args.device)
    agent = load_agent(agent_config, env, device=args.device)
    recover = True if args.recover else args.recover_from
    evaluation = Evaluation(env, agent, directory=args.directory,
                            num_episodes=args.episodes, training=args.train,
                            sim_seed=args.seed, recover=recover)
    if args.train:
        evaluation.train()
    else:
        evaluation.test()
    print(f"Run directory: {evaluation.run_directory}")
    print(f"Episode rewards: {[round(r, 1) for r in evaluation.episode_rewards]}")
    return str(evaluation.run_directory)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")
    if args.command == "evaluate":
        evaluate(args.environment, args.agent, args)


if __name__ == "__main__":
    main()
