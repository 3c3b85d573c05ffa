"""Planner-efficiency study: simple regret / return vs budget.

Port of ``scripts/planners_evaluation.py`` (reference:
scripts/planners_evaluation.py:1-302): sweep planning budgets over a
log-range for several planners and seeds, write a CSV with the reference's
column schema (agent,budget,seed,total_reward,return,mean_return,length,
simple_regret,gap; reference: planners_evaluation.py:178-190), and plot
return-vs-budget and regret-vs-budget curves where matplotlib is installed.
Simple regret is measured against a Value Iteration oracle at the initial
state (reference: planners_evaluation.py:147-156):
``r_n = Q*(s0, a*) - Q*(s0, a_planner)``; ``gap`` is the optimality gap to the
second-best action. The seed axis is a host loop; each plan runs on
``--device``.

Usage:
  python -m rl_agents_torch.scripts.planners_evaluation [--env ENV_JSON]
      [--budgets N] [--budget-max X] [--seeds N] [--agents NAME ...]
      [--out DIR] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and the run fails when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from rl_agents_torch.factory import load_agent, load_environment

SCRIPTS = Path(__file__).resolve().parent.parent.parent / "scripts"
gamma = 0.8
COLUMNS = ["agent", "budget", "seed", "total_reward", "return", "mean_return",
           "length", "simple_regret", "gap"]  # reference: planners_evaluation.py:178-190


def agent_configs():
    """(reference: planners_evaluation.py:53-124, same planner lineup)"""
    return {
        "random": {"__class__": "RandomUniformAgent"},
        "KL-OLOP": {"__class__": "OLOPAgent", "gamma": gamma,
                    "upper_bound": {"type": "kullback-leibler", "time": "global",
                                    "threshold": "4*np.log(time)"}},
        "OPD": {"__class__": "DeterministicPlannerAgent", "gamma": gamma},
        "UCT": {"__class__": "MCTSAgent", "gamma": gamma, "temperature": 30},
        "BRUE": {"__class__": "BRUEAgent", "gamma": gamma},
        "GBOP-D": {"__class__": "GraphBasedPlannerAgent", "gamma": gamma},
        "GBOP": {"__class__": "StochasticGraphBasedPlannerAgent", "gamma": gamma,
                 "max_next_states_count": 2},
        "MDP-GapE": {"__class__": "MDPGapEAgent", "gamma": gamma, "accuracy": 0.2,
                     "max_next_states_count": 2},
    }


def parse_env_arg(env):
    """An env JSON file path or an inline JSON object string."""
    if isinstance(env, str) and env.strip().startswith("{"):
        return json.loads(env)
    return env


def make_oracle(env_config, device):
    """The VI oracle's Q* ``[S, A]`` for simple-regret measurement, or None
    when the env exposes no finite MDP (reference:
    planners_evaluation.py:146-156 gates regret the same way)."""
    from rl_agents_torch.agents.dynamic_programming.value_iteration import ValueIterationAgent

    env = load_environment(env_config, device=device)
    if getattr(env, "mdp", None) is None:
        return None
    vi = ValueIterationAgent(env, {"gamma": gamma, "iterations": int(3 / (1 - gamma))},
                             device=device)
    return np.asarray(vi.state_action_value)


def evaluate_cell(env_config, agent_name, agent_config, budget, seeds, q_oracle, device,
                  max_steps=30):
    """One (agent, budget) cell: rows with the reference's result schema
    (reference: planners_evaluation.py:126-194)."""
    rows = []
    for seed in range(seeds):
        env = load_environment(env_config, device=device)
        agent = load_agent({**agent_config, "budget": int(budget)}, env, device=device)
        agent.seed(seed)
        obs, _ = env.reset(seed=seed)

        if q_oracle is not None:
            s0 = int(obs)
            first_action = int(np.asarray(agent.act(obs)))
            best_action = int(np.argmax(q_oracle[s0]))
            simple_regret = float(q_oracle[s0, best_action] - q_oracle[s0, first_action])
            order = np.sort(q_oracle[s0])
            gap = float(order[-1] - order[-2]) if len(order) > 1 else 0.0
            agent.reset()
        else:
            simple_regret, gap = 0.0, 0.0

        rewards = []
        done = trunc = False
        while not (done or trunc) and len(rewards) < max_steps:
            action = agent.act(obs)
            obs, r, done, trunc, _ = env.step(action)
            rewards.append(float(r))

        def cum_discount(signal):
            return float(sum(gamma ** t * x for t, x in enumerate(signal)))

        rows.append({
            "agent": agent_name, "budget": int(budget), "seed": seed,
            "total_reward": float(np.sum(rewards)),
            "return": cum_discount(rewards),
            "mean_return": float(np.mean([cum_discount(rewards[t:])
                                          for t in range(len(rewards))])) if rewards else 0.0,
            "length": len(rewards),
            "simple_regret": simple_regret,
            "gap": gap,
        })
    return rows


def write_csv(csv_path, rows):
    with open(csv_path, "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for row in rows:
            f.write(",".join(str(row[c]) for c in COLUMNS) + "\n")
    print(f"Wrote {csv_path}")


def plot_all(out, rows, agent_names):
    """Return- and regret-vs-budget curves (reference:
    planners_evaluation.py:246-280; seaborn lineplot -> matplotlib means)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    for field, yscale in [("total_reward", "linear"), ("simple_regret", "symlog")]:
        fig, ax = plt.subplots()
        for name in agent_names:
            data = [(r["budget"], r[field]) for r in rows if r["agent"] == name]
            bs = sorted(set(b for b, _ in data))
            means = [np.mean([v for b, v in data if b == bb]) for bb in bs]
            ax.plot(bs, means, marker="o", label=name)
        ax.set_xscale("log")
        if yscale == "symlog":
            ax.set_yscale("symlog", linthresh=1e-3)
        ax.set_xlabel("budget")
        ax.set_ylabel(field)
        ax.legend()
        fig.savefig(out / f"{field}_vs_budget.png", dpi=120)
        plt.close(fig)
        print(f"Wrote {out / (field + '_vs_budget.png')}")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--env", default=str(SCRIPTS / "configs" / "FiniteMDPEnv"
                                             / "env_loop.json"))
    parser.add_argument("--budgets", type=int, default=4,
                        help="number of budget points in logspace(1, budget-max)")
    parser.add_argument("--budget-max", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--agents", nargs="*", default=None)
    parser.add_argument("--out", default="out/planners")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    budgets = np.unique(np.logspace(1, args.budget_max, args.budgets).astype(int))
    configs = agent_configs()
    if args.agents:
        configs = {k: v for k, v in configs.items() if k in args.agents}

    env_config = parse_env_arg(args.env)
    q_oracle = make_oracle(env_config, args.device)
    rows = []
    for name, config in configs.items():
        for budget in budgets:
            cell = evaluate_cell(env_config, name, config, budget, args.seeds, q_oracle,
                                 args.device)
            rows.extend(cell)
            rets = [r["return"] for r in cell]
            regs = [r["simple_regret"] for r in cell]
            print(f"{name:10s} budget {budget:5d}: "
                  f"return {np.mean(rets):.3f} +- {np.std(rets):.3f}  "
                  f"regret {np.mean(regs):.3f}")

    write_csv(out / "data.csv", rows)
    plot_all(out, rows, list(configs))
    return rows


if __name__ == "__main__":
    main()
