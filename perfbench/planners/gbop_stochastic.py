"""Stochastic GBOP: how the loops call the program's planner and its plain
reference, and what they compare."""
from __future__ import annotations

import torch

from perfbench.counts import gbop_stochastic as counts
from perfbench.counts import kl_pair
from perfbench.pbcore import draws as draw
from perfbench.reference import gbop_stochastic as ref_gbop

DISCRETE = ("actions", "visited", "n_count", "c_count", "sa_count", "sa_keys", "sa_child", "sa_n",
            "used")
FLOATS = ("sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "value_lower", "value_upper")
STATES = False
# the observation's length: the position over the grid and the wind's 8 indicators
OBS = 2 + 8
# the sweeps an episode counted as compulsory: the first (every graph's
# residual starts unbounded); the others depend on the data
COUNTED_SWEEPS = 1


def units(config: dict) -> int:
    """What a whole plan is counted in: episodes."""
    return config["sizes"]["episodes"]


def work(config: dict, trees: int) -> int:
    """Env-steps of a plan: trees x episodes x horizon."""
    s = config["sizes"]
    return trees * s["episodes"] * s["horizon"]


def plan_draws(config: dict, trees: int, gen: torch.Generator) -> dict:
    """The draws of a plan: the optimistic action's Gumbel tie breaks
    ``[episodes, horizon, trees, actions]``, the root's ``[trees, actions]``,
    then the wind's uniforms ``[episodes, horizon, trees]``."""
    s = config["sizes"]
    E, H, A = s["episodes"], s["horizon"], s["num_actions"]
    noise = draw.gumbel((E, H, trees, A), gen)
    final_noise = draw.gumbel((trees, A), gen)
    env_noise = torch.rand((E, H, trees), generator=gen, device=gen.device)
    return {"noise": noise, "final_noise": final_noise, "env_noise": env_noise}


def _kwargs(config: dict) -> dict:
    s = config["sizes"]
    return dict(num_actions=s["num_actions"], episodes=s["episodes"], horizon=s["horizon"],
                width=s["width"], gamma=s["gamma"], accuracy=s["accuracy"],
                reward_threshold_coeff=s["reward_threshold_coeff"],
                transition_threshold_coeff=s["transition_threshold_coeff"],
                vi_sweeps=s["vi_sweeps"])


# (env, trees) whose cut plans ran: on a card each cut is a signature of its
# own, captured at its first plan
_warmed: set = set()


def program_plan(config: dict, env, params, states0, drawn: dict, device, units_run=None) -> dict:
    """The program's plan, or one cut to its first ``units_run`` episodes.
    The first whole plan (the warm-up) also runs the cuts the traced run
    profiles, so that their first plans, which capture, are not profiled."""
    key = (id(env), states0[0].shape[0])
    if units_run is None and key not in _warmed:
        _warmed.add(key)
        for cut in config["profile_units"]["batch_plan"]:
            if int(cut) < units(config):
                _plan(config, env, params, states0, drawn, device, int(cut))
    return _plan(config, env, params, states0, drawn, device, units_run)


def _plan(config: dict, env, params, states0, drawn: dict, device, units_run) -> dict:
    from rl_agents_torch.agents.tree_search.batch import gbop_stochastic_plan_batch

    kwargs = _kwargs(config)
    noise, env_noise = drawn["noise"], drawn["env_noise"]
    if units_run is not None:
        kwargs["episodes"] = units_run
        noise, env_noise = noise[:units_run], env_noise[:units_run]
    action, graph = gbop_stochastic_plan_batch(
        env, params, states0, env.observe(params, states0), None,
        noise=(noise, drawn["final_noise"]), env_noise=env_noise, device=device, **kwargs)
    return dict(graph._asdict(), actions=action)


def reference_plan(config: dict, env, model, scenes, drawn: dict, dtype=torch.float32) -> dict:
    action, graph = ref_gbop.plan(env, model, scenes, drawn["noise"], drawn["final_noise"],
                                  drawn["env_noise"], dtype=dtype, **_kwargs(config))
    return dict(graph._asdict(), actions=action)


def transition_rows(config: dict, states0, drawn: dict):
    """The rows one step of an episode steps: every graph's start state once,
    under the first tie-break draw's action."""
    return states0, drawn["noise"][0, 0].argmax(dim=-1)


def _shape(config: dict, trees: int) -> tuple:
    s = config["sizes"]
    return (trees, s["num_actions"], s["width"], s["episodes"], s["horizon"], OBS,
            COUNTED_SWEEPS)


def plan_counts(config: dict, trees: int) -> tuple:
    shape = _shape(config, trees)
    return counts.plan_ops(*shape), counts.plan_bytes(*shape)


def kernel_counts(config: dict, trees: int) -> dict:
    """The paired KL launch of a step: one entry a graph, no mask (no tree's
    flag read) and a 0-d threshold (one float32)."""
    return {"kl_bounds_pair": {"ops": kl_pair.launch_ops(trees),
                               "bytes": kl_pair.launch_bytes(trees, 0, 1)}}
