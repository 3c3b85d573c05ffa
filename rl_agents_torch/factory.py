"""Agent/environment factory: registry-by-name instead of reflection.

Port of ``rl_agents_tpu/factory.py`` (reference:
rl_agents/agents/common/factory.py:12-116). The registries list every agent
and env id of the JAX package's; an unknown agent name raises
``NotImplementedError``, and an unknown env id falls back to the host
gymnasium bridge (``envs/bridge.py``). Reference-style class paths
(``"<class 'rl_agents...XAgent'>"``) resolve by their trailing class name, so
the JSON config corpus works unmodified.
"""
from __future__ import annotations

import copy
import importlib
import json
import logging
from pathlib import Path
from typing import Dict

from rl_agents_torch.configuration import load_json_config

logger = logging.getLogger(__name__)

# name -> "module:Class", imported on first use
AGENT_REGISTRY: Dict[str, str] = {
    "BRUEAgent": "rl_agents_torch.agents.tree_search.brue:BRUEAgent",
    "BFTQAgent": "rl_agents_torch.agents.budgeted_ftq.agent:BFTQAgent",
    "CEMAgent": "rl_agents_torch.agents.cem:CEMAgent",
    "ConstrainedEPCAgent": "rl_agents_torch.agents.robust.constrained_epc:ConstrainedEPCAgent",
    "DQNAgent": "rl_agents_torch.agents.dqn.agent:DQNAgent",
    "DeterministicPlannerAgent":
        "rl_agents_torch.agents.tree_search.deterministic:DeterministicPlannerAgent",
    "DiscreteRobustPlannerAgent": "rl_agents_torch.agents.robust.robust:DiscreteRobustPlannerAgent",
    "FTQAgent": "rl_agents_torch.agents.fitted_q:FTQAgent",
    "GraphBasedPlannerAgent": "rl_agents_torch.agents.tree_search.graph_based:GraphBasedPlannerAgent",
    "IntervalFeedbackAgent": "rl_agents_torch.agents.control:IntervalFeedbackAgent",
    "IntervalRobustPlannerAgent": "rl_agents_torch.agents.robust.robust:IntervalRobustPlannerAgent",
    "LatentCEMAgent": "rl_agents_torch.agents.cem:LatentCEMAgent",
    "LinearFeedbackAgent": "rl_agents_torch.agents.control:LinearFeedbackAgent",
    "MCTSAgent": "rl_agents_torch.agents.tree_search.mcts:MCTSAgent",
    "MCTSDPWAgent": "rl_agents_torch.agents.tree_search.mcts_dpw:MCTSDPWAgent",
    "MCTSWithPriorPolicyAgent":
        "rl_agents_torch.agents.tree_search.mcts_with_prior:MCTSWithPriorPolicyAgent",
    "MDPGapEAgent": "rl_agents_torch.agents.tree_search.mdp_gape:MDPGapEAgent",
    "NominalEPCAgent": "rl_agents_torch.agents.robust.robust_epc:NominalEPCAgent",
    "OLOPAgent": "rl_agents_torch.agents.tree_search.olop:OLOPAgent",
    "OpenLoopAgent": "rl_agents_torch.agents.simple:OpenLoopAgent",
    "PlaTyPOOSAgent": "rl_agents_torch.agents.tree_search.platypoos:PlaTyPOOSAgent",
    "RandomUniformAgent": "rl_agents_torch.agents.simple:RandomUniformAgent",
    "RobustEPCAgent": "rl_agents_torch.agents.robust.robust_epc:RobustEPCAgent",
    "RobustValueIterationAgent":
        "rl_agents_torch.agents.dynamic_programming.robust_value_iteration:RobustValueIterationAgent",
    "SparseSamplingAgent":
        "rl_agents_torch.agents.tree_search.sparse_sampling:SparseSamplingAgent",
    "StateAwarePlannerAgent": "rl_agents_torch.agents.tree_search.state_aware:StateAwarePlannerAgent",
    "StochasticGraphBasedPlannerAgent":
        "rl_agents_torch.agents.tree_search.graph_based_stochastic:StochasticGraphBasedPlannerAgent",
    "ValueIterationAgent":
        "rl_agents_torch.agents.dynamic_programming.value_iteration:ValueIterationAgent",
}

ENV_REGISTRY: Dict[str, str] = {
    "finite-mdp": "rl_agents_torch.envs.finite_mdp:make",
    "cartpole": "rl_agents_torch.envs.cartpole:make",
    "gridenv": "rl_agents_torch.envs.gridenv:make_grid",
    "lineenv": "rl_agents_torch.envs.gridenv:make_line",
    "dynamics": "rl_agents_torch.envs.dynamics:make",
    "mountaincar": "rl_agents_torch.envs.classic:make_mountaincar",
    "pendulum": "rl_agents_torch.envs.classic:make_pendulum",
    "linear-system": "rl_agents_torch.envs.linear:make",
    "highway": "rl_agents_torch.envs.highway:make",
    "intersection": "rl_agents_torch.envs.highway:make_intersection",
    # reference corpus ids, mapped onto the functional surrogates
    "finite-mdp-v0": "rl_agents_torch.envs.finite_mdp:make",
    "highway-v0": "rl_agents_torch.envs.highway:make",
    "exit-v0": "rl_agents_torch.envs.highway:make",
    "merge-v0": "rl_agents_torch.envs.highway:make",
    "intersection-v0": "rl_agents_torch.envs.highway:make_intersection",
    "intersection-multi-agent-v0": "rl_agents_torch.envs.highway:make_intersection",
    # roundabout keeps highway-env's 5 meta-actions: a 2-lane ring
    # approximated by the lane-change surrogate
    "roundabout-v0": "rl_agents_torch.envs.highway:make_roundabout",
    "two-way-v0": "rl_agents_torch.envs.highway:make_twoway",
    "MiniGrid-Empty-16x16-v0": "rl_agents_torch.envs.minigrid:make",
    "MiniGrid-Collect-9x9-v0": "rl_agents_torch.envs.minigrid:make",
    "MiniGrid-Collect-Stochastic-9x9-v0": "rl_agents_torch.envs.minigrid:make",
    "sailing-v0": "rl_agents_torch.envs.sailing:make",
    "sailing-5-v0": "rl_agents_torch.envs.sailing:make",
    "sailing-10-v0": "rl_agents_torch.envs.sailing:make",
    "sailing-20-v0": "rl_agents_torch.envs.sailing:make",
    "parking-v0": "rl_agents_torch.envs.parking:make",
    "parking-ActionRepeat-v0": "rl_agents_torch.envs.parking:make",
    "lane-keeping-v0": "rl_agents_torch.envs.linear:make_lane_keeping",
}


def _resolve(spec: str):
    module_name, _, attr = spec.partition(":")
    return getattr(importlib.import_module(module_name), attr)


def agent_class(name: str):
    """Resolve an agent class from a registry name or a class path."""
    if name.startswith("<class '") and name.endswith("'>"):
        name = name[len("<class '"):-len("'>")]
    short = name.rsplit(".", 1)[-1]
    if short in AGENT_REGISTRY:
        return _resolve(AGENT_REGISTRY[short])
    raise NotImplementedError(f"agent {name!r} is not yet ported to rl_agents_torch")


def agent_factory(environment, config: Dict, device="cuda"):
    """Instantiate an agent for an environment from its config dict."""
    if "__class__" not in config:
        raise ValueError('The configuration should specify the agent "__class__"')
    cls = agent_class(config["__class__"])
    return cls(environment, config, device=device)


def load_agent_config(config_path: str | Path) -> Dict:
    path = Path(config_path)
    if not path.is_file() and not path.is_absolute():
        # the corpus spells cross-references relative to scripts/
        scripts = Path(__file__).resolve().parent.parent / "scripts"
        if (scripts / path).is_file():
            path = scripts / path
    return load_json_config(path)


def load_agent(agent_config: Dict | str | Path, env, device="cuda"):
    """Load an agent from a config dict or JSON config file path."""
    if not isinstance(agent_config, dict):
        agent_config = load_agent_config(agent_config)
    return agent_factory(env, agent_config, device=device)


def load_environment(env_config: Dict | str | Path, device="cuda"):
    """Build an environment handle on ``device`` from a config dict or JSON
    file; the env is selected by ``"id"`` through ``ENV_REGISTRY``. Any other
    id goes to the host gymnasium bridge, which ignores ``device``."""
    if not isinstance(env_config, dict):
        with open(env_config) as f:
            env_config = json.load(f)
    env_id = env_config.get("id")
    if env_id not in ENV_REGISTRY:
        from rl_agents_torch.envs.bridge import make_gym_env

        return make_gym_env(env_config)
    make = _resolve(ENV_REGISTRY[env_id])
    if "config" in env_config:
        return make(dict(env_config["config"], id=env_id), device=device)
    return make(dict(env_config), device=device)


def preprocess_env(env, preprocessor_configs):
    """Apply named env preprocessors (reference: factory.py:97-116)."""
    for pconfig in preprocessor_configs or []:
        if "method" not in pconfig:
            logger.error("The environment preprocessor config must have a 'method' field: %s", pconfig)
            continue
        name, args = pconfig["method"], pconfig.get("args", ())
        if hasattr(env, "preprocess"):
            env = env.preprocess(name, args)
        elif hasattr(env, name):
            env = getattr(env, name)(*args) or env
        else:
            logger.warning("Environment has no preprocessor %s", name)
    return env


def safe_deepcopy_env(obj):
    """Fork an environment: handles stamp their state into a new handle."""
    if hasattr(obj, "fork"):
        return obj.fork()
    return copy.deepcopy(obj)
