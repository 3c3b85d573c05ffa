"""KL-OLOP: how the loops call the program's planner and its plain
reference, and what they compare."""
from __future__ import annotations

import torch

from perfbench.counts import kl as kl_counts
from perfbench.counts import olop as counts
from perfbench.reference import olop as ref_olop

DISCRETE = ("actions", "lengths", "parent", "children", "depth", "count", "done", "used")
FLOATS = ("cum_reward", "mu_ucb", "value_upper")
STATES = False


def units(config: dict) -> int:
    """What a whole plan is counted in: episodes."""
    return config["sizes"]["episodes"]


def work(config: dict, trees: int) -> int:
    """Env-steps of a plan: trees x episodes x horizon."""
    s = config["sizes"]
    return trees * s["episodes"] * s["horizon"]


def plan_draws(config: dict, trees: int, gen: torch.Generator) -> dict:
    s = config["sizes"]
    return {"random_actions": torch.randint(0, s["num_actions"],
                                            (s["episodes"], s["horizon"], trees),
                                            generator=gen, device=gen.device)}


def _kwargs(config: dict) -> dict:
    s = config["sizes"]
    return dict(num_actions=s["num_actions"], episodes=s["episodes"], horizon=s["horizon"],
                gamma=s["gamma"], threshold_coeff=s["threshold_coeff"])


def program_plan(config: dict, env, params, states0, drawn: dict, device, units_run=None) -> dict:
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch

    kwargs = _kwargs(config)
    random_actions = drawn["random_actions"]
    if units_run is not None:
        kwargs["episodes"] = units_run
        random_actions = random_actions[:units_run]
    actions, lengths, tree = olop_plan_batch(env, params, states0, None,
                                             random_actions=random_actions,
                                             continuation_uniform=True, device=device, **kwargs)
    return dict(tree._asdict(), actions=actions, lengths=lengths)


def reference_plan(config: dict, env, model, scenes, drawn: dict, dtype=torch.float32) -> dict:
    actions, lengths, tree = ref_olop.plan(env, model, scenes, drawn["random_actions"],
                                           dtype=dtype, **_kwargs(config))
    return dict(tree._asdict(), actions=actions, lengths=lengths)


def transition_rows(config: dict, states0, drawn: dict):
    """The rows one step of an episode steps: every tree's scene once."""
    return states0, drawn["random_actions"][0, 0]


def plan_counts(config: dict, trees: int) -> tuple:
    s = config["sizes"]
    return (counts.plan_ops(trees, s["vehicles"], s["num_actions"], s["episodes"], s["horizon"]),
            counts.plan_bytes(trees, s["vehicles"], s["num_actions"], s["episodes"], s["horizon"]))


def kernel_counts(config: dict, trees: int) -> dict:
    """The KL launch of one episode: its path's ``horizon x trees`` nodes."""
    nodes = config["sizes"]["horizon"] * trees
    return {"kl_bound_indexed": {"bytes": kl_counts.launch_bytes(nodes),
                                 "ops": kl_counts.launch_ops(nodes)}}
