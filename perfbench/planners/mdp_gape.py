"""MDP-GapE: how the loops call the program's planner and its plain
reference, and what they compare."""
from __future__ import annotations

import torch

from perfbench.counts import kl_pair
from perfbench.counts import mdp_gape as counts
from perfbench.pbcore import draws as draw
from perfbench.reference import garnet
from perfbench.reference import mdp_gape as ref_gape

DISCRETE = ("actions", "episodes_used", "d_parent", "d_depth", "d_count", "d_children",
            "d_done", "c_parent", "c_depth", "c_count", "c_child_keys", "c_children",
            "c_n_children", "d_used", "c_used")
FLOATS = ("d_cum_reward", "d_mu_ucb", "d_mu_lcb", "d_value_upper", "d_value_lower",
          "c_value_upper", "c_value_lower")
STATES = False


def units(config: dict) -> int:
    """What a whole plan is counted in: the budget's episodes (a plan of E
    runs E + 1)."""
    return config["sizes"]["episodes"]


def work(config: dict, trees: int) -> int:
    """Env-steps of a plan: trees x (episodes + 1) x horizon."""
    s = config["sizes"]
    return trees * (s["episodes"] + 1) * s["horizon"]


def plan_draws(config: dict, trees: int, gen: torch.Generator) -> dict:
    """The Gumbel draws of a plan: the optimistic action's tie breaks
    ``[episodes + 1, horizon, trees, actions]``, then the garnet's
    categorical draws ``[episodes + 1, horizon, trees, branching]``."""
    s = config["sizes"]
    runs, H = s["episodes"] + 1, s["horizon"]
    noise = draw.gumbel((runs, H, trees, s["num_actions"]), gen)
    env_noise = draw.gumbel((runs, H, trees, s["branching"]), gen)
    return {"noise": noise, "env_noise": env_noise}


def _kwargs(config: dict) -> dict:
    s = config["sizes"]
    return dict(num_actions=s["num_actions"], episodes=s["episodes"], horizon=s["horizon"],
                width=s["width"], gamma=s["gamma"], accuracy=s["accuracy"],
                confidence=s["confidence"],
                transition_threshold_coeff=s["transition_threshold_coeff"])


def program_plan(config: dict, env, params, states0, drawn: dict, device, units_run=None) -> dict:
    """The program's plan; the reward threshold is ``sizes``'s coefficient of
    ``log(episodes)``."""
    from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch

    kwargs = dict(_kwargs(config), reward_threshold_coeff=config["sizes"]["reward_threshold_coeff"])
    noise, env_noise = drawn["noise"], drawn["env_noise"]
    if units_run is not None:
        kwargs["episodes"] = units_run
        noise, env_noise = noise[:units_run + 1], env_noise[:units_run + 1]
    best, used, tree = mdp_gape_plan_batch(env, params, states0, None, noise=noise,
                                           env_noise=env_noise, device=device, **kwargs)
    return dict(tree._asdict(), actions=best, episodes_used=used)


def reference_plan(config: dict, env, model, scenes, drawn: dict, dtype=torch.float32) -> dict:
    model = garnet.to(model, scenes.s.device)
    best, used, tree = ref_gape.plan(env, model, scenes, drawn["noise"], drawn["env_noise"],
                                     threshold=config["agent"]["upper_bound"]["threshold"],
                                     dtype=dtype, **_kwargs(config))
    return dict(tree._asdict(), actions=best, episodes_used=used)


def transition_rows(config: dict, states0, drawn: dict):
    """The rows one step of an episode steps: every tree's start state once,
    under the first tie-break draw's action."""
    return states0, drawn["noise"][0, 0].argmax(dim=-1)


def _shape(config: dict, trees: int) -> tuple:
    s = config["sizes"]
    return (trees, s["num_actions"], s["width"], s["branching"], s["episodes"], s["horizon"])


def plan_counts(config: dict, trees: int) -> tuple:
    shape = _shape(config, trees)
    return counts.plan_ops(*shape), counts.plan_bytes(*shape)


def kernel_counts(config: dict, trees: int) -> dict:
    """The paired KL launch of an episode: the path's ``horizon x trees``
    entries, the mask and the threshold table of ``episodes + 2`` counts."""
    s = config["sizes"]
    entries = s["horizon"] * trees
    return {"kl_bounds_pair": {"ops": kl_pair.launch_ops(entries),
                               "bytes": kl_pair.launch_bytes(entries, trees, s["episodes"] + 2)}}
