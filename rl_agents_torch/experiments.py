"""Experiment CLI of the PyTorch port: evaluate an agent on an environment,
or run a benchmark of agents x environments.

Mirrors ``scripts/experiments.py`` (reference: scripts/experiments.py:1-148):

  python -m rl_agents_torch.experiments evaluate <environment.json> <agent.json>
      (--train|--test) [--episodes N] [--seed S] [--recover | --recover-from PATH]
      [--repeat R] [--verbose] [--name-from-config] [--no-display]
      [--device cuda|cpu] [--directory D]
  python -m rl_agents_torch.experiments benchmark <benchmark.json>
      [--episodes N] [--seed S] [--processes P] [--verbose]
      [--device cuda|cpu] [--directory D]

``--device`` defaults to ``cuda`` and the run fails when no CUDA device is
present; pass ``--device cpu`` to run on the CPU. A benchmark runs every
environment with every agent (its ``{"base_agent", "sweep"}`` entries
expanded), one after the other or in ``--processes`` worker processes
started with ``spawn`` (a forked child cannot use CUDA), and writes the run
directories to ``<directory>/benchmark_summary.<time>.json``. ``evaluate``
displays the env (GIFs of its episodes and a live viewer, headless without
a display) unless ``--no-display`` is given, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
from itertools import product
from pathlib import Path

from rl_agents_torch.factory import load_agent, load_agent_config, load_environment
from rl_agents_torch.trainer import logger as run_logger
from rl_agents_torch.trainer.evaluation import Evaluation

BENCHMARK_FILE = "benchmark_summary"
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
LOGGING_CONFIG = SCRIPTS / "configs" / "logging.json"
VERBOSE_CONFIG = SCRIPTS / "configs" / "verbose.json"


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--episodes", type=int, default=5)
    common.add_argument("--seed", type=int, default=None)
    common.add_argument("--verbose", action="store_true", help="log at DEBUG level")
    common.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    common.add_argument("--directory", default=None,
                        help="output directory (default: out/<env id>/<agent class>)")

    ev = sub.add_parser("evaluate", parents=[common],
                        help="evaluate an agent on an environment")
    ev.add_argument("environment", help="path to an environment JSON config")
    ev.add_argument("agent", help="path to an agent JSON config")
    mode = ev.add_mutually_exclusive_group(required=True)
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--test", action="store_true")
    ev.add_argument("--recover", action="store_true",
                    help="load the model from the latest checkpoint")
    ev.add_argument("--recover-from", type=str, default=None,
                    help="load the model from a given checkpoint path")
    ev.add_argument("--repeat", type=int, default=1, help="run the evaluation this many times")
    ev.add_argument("--name-from-config", action="store_true",
                    help="name the run directory after the agent config")
    ev.add_argument("--no-display", action="store_true",
                    help="record no episode GIFs and open no viewer")

    bench = sub.add_parser("benchmark", parents=[common],
                           help="run a benchmark of agents x environments")
    bench.add_argument("benchmark_file", help="path to a benchmark JSON config")
    bench.add_argument("--test", action="store_true",
                       help="accepted for the JAX CLI's command lines; a benchmark tests")
    bench.add_argument("--processes", type=int, default=1)
    return parser


def corpus_path(path) -> Path:
    """``path`` as given, or under ``scripts/`` where the corpus's cross
    references are spelled relative to it."""
    path = Path(path)
    if not path.exists() and not path.is_absolute() and (SCRIPTS / path).exists():
        return SCRIPTS / path
    return path


def evaluate(environment_config, agent_config, args, show: bool = True,
             run_directory: str | None = None) -> str:
    """Set up and run one evaluation (reference: experiments.py:43-82);
    return its run directory."""
    if not isinstance(environment_config, dict):
        environment_config = corpus_path(environment_config)
    env = load_environment(environment_config, device=args.device)
    agent = load_agent(agent_config, env, device=args.device)
    if getattr(args, "name_from_config", False):
        name = agent.__class__.__name__ if isinstance(agent_config, dict) \
            else Path(agent_config).with_suffix("").name
        run_directory = f"{name}_{datetime.datetime.now().strftime('%Y%m%d-%H%M%S')}_0"
    recover = True if getattr(args, "recover", False) else getattr(args, "recover_from", None)
    training = getattr(args, "train", False)  # a benchmark tests, as in JAX
    evaluation = Evaluation(env, agent, directory=args.directory, run_directory=run_directory,
                            num_episodes=args.episodes, training=training,
                            sim_seed=args.seed, recover=recover,
                            display_env=not getattr(args, "no_display", True))
    if training:
        evaluation.train()
    else:
        evaluation.test()
    if show:
        print(f"Run directory: {evaluation.run_directory}")
        print(f"Episode rewards: {[round(r, 1) for r in evaluation.episode_rewards]}")
    return str(evaluation.run_directory)


def generate_agent_configs(benchmark_config):
    """Expand ``{"base_agent": path, "sweep": {"a/b": [values]}}`` entries
    into one agent config dict per point of the sweep's product (reference:
    experiments.py:119-144); other entries pass through."""
    agents = []
    for agent_path in benchmark_config["agents"]:
        if isinstance(agent_path, dict) and "base_agent" in agent_path:
            base = load_agent_config(agent_path["base_agent"])
            keys, value_lists = zip(*agent_path["sweep"].items())
            for values in product(*value_lists):
                config = json.loads(json.dumps(base))
                for key, value in zip(keys, values):
                    node = config
                    parts = key.split("/")
                    for part in parts[:-1]:
                        node = node.setdefault(part, {})
                    node[parts[-1]] = value
                agents.append(config)
        else:
            agents.append(agent_path)
    return agents


def benchmark(args) -> Path:
    """Every environment with every agent (reference: experiments.py:85-116);
    returns the summary file."""
    with open(args.benchmark_file) as f:
        benchmark_config = json.load(f)
    agents = generate_agent_configs(benchmark_config)
    environments = benchmark_config["environments"]
    experiments = list(product(environments, agents))
    print(f"Running {len(experiments)} experiments "
          f"({len(environments)} environments x {len(agents)} agents)")
    stamp = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    jobs = [(env, agent, args, False, f"run_{stamp}_{i}")
            for i, (env, agent) in enumerate(experiments)]
    if args.processes > 1:
        with multiprocessing.get_context("spawn").Pool(args.processes) as pool:
            results = pool.starmap(evaluate, jobs)
    else:
        results = [evaluate(*job) for job in jobs]
    summary = Path(args.directory or Evaluation.OUTPUT_FOLDER) / f"{BENCHMARK_FILE}.{stamp}.json"
    summary.parent.mkdir(parents=True, exist_ok=True)
    summary.write_text(json.dumps(results, indent=2))
    print(f"Benchmark summary written to {summary}")
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = VERBOSE_CONFIG if args.verbose else LOGGING_CONFIG
    run_logger.configure(json.loads(config.read_text()))
    if args.command == "evaluate":
        for _ in range(args.repeat):
            evaluate(args.environment, args.agent, args)
    elif args.command == "benchmark":
        benchmark(args)


if __name__ == "__main__":
    main()
