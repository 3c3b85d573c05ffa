"""MCTS: how the loops call the program's planner and its plain reference,
and what they compare."""
from __future__ import annotations

import torch

from perfbench.counts import mcts as counts
from perfbench.pbcore import draws as draw
from perfbench.reference import mcts as ref_mcts

DISCRETE = ("actions", "lengths", "parent", "children", "count", "used")
FLOATS = ("value",)
STATES = False


def units(config: dict) -> int:
    """What a whole plan is counted in: episodes."""
    return config["sizes"]["episodes"]


def work(config: dict, trees: int) -> int:
    """Env-steps of a plan: trees x episodes x horizon."""
    s = config["sizes"]
    return trees * s["episodes"] * s["horizon"]


def plan_draws(config: dict, trees: int, gen: torch.Generator) -> dict:
    """The Gumbel draws of a plan, ``[episodes, horizon, 2, actions, trees]``:
    the descent's tie break and the rollout's action at each step."""
    s = config["sizes"]
    return {"noise": draw.gumbel((s["episodes"], s["horizon"], 2, s["num_actions"], trees), gen)}


def _kwargs(config: dict) -> dict:
    s = config["sizes"]
    return dict(num_actions=s["num_actions"], episodes=s["episodes"], horizon=s["horizon"],
                gamma=s["gamma"], temperature=s["temperature"])


def uniform(config: dict, device) -> torch.Tensor:
    """The prior and rollout policies: uniform over the actions, made on the
    device (the agent's ``random_available`` gives every action here)."""
    A = config["sizes"]["num_actions"]
    return torch.full((A,), 1.0 / A, dtype=torch.float32, device=device)


def program_plan(config: dict, env, params, states0, drawn: dict, device, units_run=None) -> dict:
    from rl_agents_torch.agents.tree_search.batch import mcts_plan_batch

    kwargs = _kwargs(config)
    noise = drawn["noise"]
    if units_run is not None:
        kwargs["episodes"] = units_run
        noise = noise[:units_run]
    probs = uniform(config, device)
    actions, lengths, tree = mcts_plan_batch(env, params, states0, None, probs, probs,
                                             noise=noise, device=device, **kwargs)
    return dict(tree._asdict(), actions=actions, lengths=lengths)


def reference_plan(config: dict, env, model, scenes, drawn: dict, dtype=torch.float32) -> dict:
    probs = uniform(config, scenes[0].device)
    actions, lengths, tree = ref_mcts.plan(env, model, scenes, drawn["noise"], probs, probs,
                                           dtype=dtype, **_kwargs(config))
    return dict(tree._asdict(), actions=actions, lengths=lengths)


def transition_rows(config: dict, states0, drawn: dict):
    """The rows one step of an episode steps: every tree's scene once, under
    the first rollout draw's action."""
    return states0, drawn["noise"][0, 0, 1].argmax(dim=0)


def plan_counts(config: dict, trees: int) -> tuple:
    s = config["sizes"]
    shape = (trees, s["vehicles"], s["num_actions"], s["episodes"], s["horizon"])
    return counts.plan_ops(*shape), counts.plan_bytes(*shape)


def kernel_counts(config: dict, trees: int) -> dict:
    return {}  # MCTS launches no kernel of the port's own
