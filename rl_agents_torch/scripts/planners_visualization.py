"""Render expanded planner trees on toy environments.

Port of ``scripts/planners_visualization.py`` (reference:
scripts/planners_visualization.py): plan once with several planners on a toy
env and save each tree 0's figure (``graphics/tree_plot.py``).

Usage:
  python -m rl_agents_torch.scripts.planners_visualization [--out DIR]
      [--budget N] [--env ENV_JSON] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the run fails when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rl_agents_torch.factory import load_agent, load_environment
from rl_agents_torch.graphics.tree_plot import TreePlot

AGENTS = {
    "opd": {"__class__": "DeterministicPlannerAgent", "gamma": 0.8},
    "uct": {"__class__": "MCTSAgent", "gamma": 0.8},
    "kl-olop": {"__class__": "OLOPAgent", "gamma": 0.8},
}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default="out/trees")
    parser.add_argument("--budget", type=int, default=100)
    parser.add_argument("--env", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env_config = args.env or {"id": "gridenv"}
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = {}
    for name, config in AGENTS.items():
        env = load_environment(env_config, device=args.device)
        agent = load_agent({**config, "budget": args.budget}, env, device=args.device)
        agent.seed(0)
        obs, _ = env.reset(seed=0)
        agent.plan(obs)
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.axis("off")
        ax.set_title(name)
        TreePlot(agent.last_plan_data, max_depth=6).plot(ax)
        paths[name] = out / f"{name}.png"
        fig.savefig(paths[name], dpi=120)
        plt.close(fig)
        print(f"Wrote {paths[name]}")
    return paths


if __name__ == "__main__":
    main()
