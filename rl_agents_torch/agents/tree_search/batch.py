"""Tree-batch entry points for the arena planners.

Port of ``rl_agents_tpu/agents/tree_search/batch.py``. The JAX package vmaps
a single-tree planner over a leading batch axis of ``states0`` and ``keys``;
the port's planners are batch-first already, so each entry point is a name
over its planner with the same call convention, a ``torch.Generator`` in
place of the per-tree keys.
"""
from __future__ import annotations

from rl_agents_torch.agents.robust.robust import robust_opd_plan
from rl_agents_torch.agents.tree_search.brue import brue_plan
from rl_agents_torch.agents.tree_search.deterministic import (  # noqa: F401 (re-export)
    opd_plan_batch,
)
from rl_agents_torch.agents.tree_search.graph_based import gbop_plan
from rl_agents_torch.agents.tree_search.graph_based_stochastic import gbop_stochastic_plan
from rl_agents_torch.agents.tree_search.mcts import mcts_plan_batch  # noqa: F401 (re-export)
from rl_agents_torch.agents.tree_search.mcts_closed_loop import mcts_closed_loop_plan
from rl_agents_torch.agents.tree_search.mcts_dpw import mcts_dpw_plan
from rl_agents_torch.agents.tree_search.mdp_gape import mdp_gape_plan
from rl_agents_torch.agents.tree_search.olop import olop_plan
from rl_agents_torch.agents.tree_search.sparse_sampling import sparse_sampling_plan
from rl_agents_torch.agents.tree_search.state_aware import state_aware_plan


def olop_plan_batch(env, params, states0, generator=None, **kw):
    """Batched KL-OLOP (reference: olop.py:11-200, swept by the study at
    scripts/planners_evaluation.py:53-124). Returns ``(actions [B, H],
    lengths [B], OLOPTree)``."""
    return olop_plan(env, params, states0, generator, **kw)


def brue_plan_batch(env, params, states0, generator=None, **kw):
    """Batched BRUE (reference: brue.py:11-123). Returns ``(action [B],
    BRUETree)``."""
    return brue_plan(env, params, states0, generator, **kw)


def sparse_sampling_plan_batch(env, params, states0, generator=None, **kw):
    """Batched sparse sampling (reference: sparse_sampling.py:11-103).
    Returns ``(action [B], q_root [B, A])``."""
    return sparse_sampling_plan(env, params, states0, generator, **kw)


def mcts_dpw_plan_batch(env, params, states0, generator, rollout_probs, **kw):
    """Batched MCTS-DPW (reference: mcts_dpw.py:10-193); each tree's
    observation keys lie along the batch axis. Returns ``(action [B],
    DPWTree)``."""
    return mcts_dpw_plan(env, params, states0, generator, rollout_probs, **kw)


def mcts_closed_loop_plan_batch(env, params, states0, generator, prior_probs, rollout_probs,
                                **kw):
    """Batched closed-loop MCTS (reference: mcts.py:147,267-273): chance
    children keyed by observed outcomes. Returns ``(action [B], DPWTree)``."""
    return mcts_closed_loop_plan(env, params, states0, generator, prior_probs, rollout_probs,
                                 **kw)


def mdp_gape_plan_batch(env, params, states0, generator=None, **kw):
    """Batched MDP-GapE (reference: mdp_gape.py:11-344). Returns ``(best
    action [B], episodes_used [B], GapETree)``."""
    return mdp_gape_plan(env, params, states0, generator, **kw)


def gbop_plan_batch(env, params, states0, obs0, generator=None, **kw):
    """Batched GBOP-D (reference: graph_based.py:12-151). Each tree owns its
    obs-key array along the batch axis. Returns ``(actions [B, P],
    lengths [B], Graph)``."""
    return gbop_plan(env, params, states0, obs0, generator, **kw)


def gbop_stochastic_plan_batch(env, params, states0, obs0, generator=None, **kw):
    """Batched stochastic GBOP (reference: graph_based_stochastic.py:15-361).
    Returns ``(action [B], StochasticGraph)``."""
    return gbop_stochastic_plan(env, params, states0, obs0, generator, **kw)


def state_aware_plan_batch(env, params, states0, obs0, generator=None, **kw):
    """Batched state-aware OPD (reference: state_aware.py:10-137). Returns
    ``(actions [B, P], lengths [B], StateAwareTree)``."""
    return state_aware_plan(env, params, states0, obs0, generator, **kw)


def robust_opd_plan_batch(env, params_ensemble, states0, generator=None, **kw):
    """Batched DROP (reference: robust.py:9-71): B trees over the M models of
    ``params_ensemble`` (a leading ``[M]`` axis on every field), from
    ``states0 [B, M, ...]``. The JAX package has no batch entry for it and
    vmaps its single-tree ``robust_opd_plan``. Returns ``(actions [B, P],
    lengths [B], RobustTree)``."""
    return robust_opd_plan(env, params_ensemble, states0, generator, **kw)
