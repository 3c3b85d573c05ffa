"""OPD: how the loops call the program's planner and its plain reference,
and what they compare."""
from __future__ import annotations

import torch

from perfbench.counts import opd as counts
from perfbench.pbcore import draws as draw
from perfbench.reference import opd as ref_opd

DISCRETE = ("actions", "lengths", "parent", "action", "depth", "children", "done", "leaf",
            "count", "used")
FLOATS = ("reward", "value_lower", "value_upper")
STATES = True  # the arena holds every node's scene, written by the env's transition


def units(config: dict) -> int:
    """What a whole plan is counted in: expansions."""
    return config["sizes"]["expansions"]


def work(config: dict, trees: int) -> int:
    """Env-steps of a plan: trees x expansions x actions."""
    s = config["sizes"]
    return trees * s["expansions"] * s["num_actions"]


def plan_draws(config: dict, trees: int, gen: torch.Generator) -> dict:
    s = config["sizes"]
    return {"noise": draw.gumbel((s["plan_capacity"], s["num_actions"], trees), gen)}


def _kwargs(config: dict) -> dict:
    s = config["sizes"]
    return dict(num_actions=s["num_actions"], expansions=s["expansions"], gamma=s["gamma"],
                terminal_reward=s["terminal_reward"], plan_capacity=s["plan_capacity"])


def program_plan(config: dict, env, params, states0, drawn: dict, device, units_run=None) -> dict:
    from rl_agents_torch.agents.tree_search.batch import opd_plan_batch

    kwargs = _kwargs(config)
    if units_run is not None:
        kwargs["expansions"] = units_run
    actions, lengths, tree = opd_plan_batch(env, params, states0, None, noise=drawn["noise"],
                                            device=device, **kwargs)
    out = dict(tree._asdict(), actions=actions, lengths=lengths)
    out["states"] = tuple(out["states"])
    return out


def reference_plan(config: dict, env, model, scenes, drawn: dict, dtype=torch.float32) -> dict:
    kwargs = _kwargs(config)
    kwargs.pop("plan_capacity")
    actions, lengths, tree = ref_opd.plan(env, model, scenes, drawn["noise"].transpose(1, 2),
                                          dtype=dtype, **kwargs)
    out = dict(tree._asdict(), actions=actions, lengths=lengths)
    out["states"] = tuple(out["states"])
    return out


def transition_rows(config: dict, states0, drawn: dict):
    """The rows one expansion round steps: every tree's scene once per action."""
    A = config["sizes"]["num_actions"]
    B = states0[0].shape[0]
    rows = type(states0)(*(x.repeat_interleave(A, dim=0) for x in states0))
    return rows, torch.arange(A, device=states0[0].device).repeat(B)


def plan_counts(config: dict, trees: int) -> tuple:
    s = config["sizes"]
    return (counts.plan_ops(trees, s["vehicles"], s["num_actions"], s["expansions"],
                            s["plan_capacity"]),
            counts.plan_bytes(trees, s["vehicles"], s["num_actions"], s["expansions"]))


def kernel_counts(config: dict, trees: int) -> dict:
    return {}  # OPD launches no kernel of the port's own


def action_values(config: dict, env, model, scenes, dtype=torch.float32):
    """The reference's value of each first action from each scene ``[K, A]``:
    the lower bound of each root child after the agent's expansions."""
    s = config["sizes"]
    K = scenes[0].shape[0]
    noise = torch.zeros((1, K, s["num_actions"]), device=scenes[0].device)
    kwargs = _kwargs(config)
    kwargs.pop("plan_capacity")
    _, _, tree = ref_opd.plan(env, model, scenes, noise, dtype=dtype, **kwargs)
    return ref_opd.root_values(tree).float()
