"""Robust planning over finite model ensembles, batch-first.

Port of ``rl_agents_tpu/agents/robust/robust.py`` (reference:
robust/robust.py:9-108):

* DROP (``DiscreteRobustPlannerAgent``): OPD over M model variants stepped in
  lockstep, each node's bounds taken as the min over the model axis
  (robust.py:42-50). The models' params are stacked on a leading ``[M]`` axis
  and every expansion steps the ``[B, A, M]`` children of B trees as one
  batch of ``B * A * M`` rows through ``env.transition``, each row with its
  model's params.
* IRP (``IntervalRobustPlannerAgent``): a sub-agent planning in an env
  preprocessed to propagate state intervals with pessimistic rewards
  (robust.py:74-108); pure delegation.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, NamedTuple

import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent
from rl_agents_torch.agents.tree_search.deterministic import _greedy_plan, _scalars
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.factory import load_agent, preprocess_env
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import noise_tensor


class RobustTree(NamedTuple):
    parent: Any        # [B, N] i64
    action: Any        # [B, N] i64
    depth: Any         # [B, N] i64
    children: Any      # [B, N, A] i64, -1 when absent
    reward: Any        # [B, N, M] f32
    done: Any          # [B, N, M] bool
    value_lower: Any   # [B, N, M] f32
    value_upper: Any   # [B, N, M] f32
    leaf: Any          # [B, N] bool
    used: Any          # [B] i64
    states: Any        # env-state NamedTuple stacked as [B, N, M, ...]


def stack_params(variants):
    """Stack a list of params NamedTuples on a new leading model axis."""
    return type(variants[0])(*(torch.stack([torch.as_tensor(v) for v in field])
                               for field in zip(*variants)))


def _init_tree(states0, capacity: int, num_actions: int, num_models: int) -> RobustTree:
    N, A, M = capacity, num_actions, num_models
    B = states0[0].shape[0]
    device = states0[0].device

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    def arena_of(x):
        arena = torch.zeros((B, N) + x.shape[1:], dtype=x.dtype, device=device)
        arena[:, 0] = x
        return arena

    leaf = full((B, N), False, torch.bool)
    leaf[:, 0] = True
    return RobustTree(
        parent=full((B, N), -1, torch.int64), action=full((B, N), -1, torch.int64),
        depth=full((B, N), 0, torch.int64), children=full((B, N, A), -1, torch.int64),
        reward=full((B, N, M), 0.0, torch.float32), done=full((B, N, M), False, torch.bool),
        value_lower=full((B, N, M), 0.0, torch.float32),
        value_upper=full((B, N, M), 0.0, torch.float32),
        leaf=leaf, used=full((B,), 1, torch.int64),
        states=type(states0)(*(arena_of(x) for x in states0)))


def _expand(env: FunctionalEnv, params_rows, tree: RobustTree, leaf_idx, base: int, scalars,
            num_actions: int) -> RobustTree:
    """Expand the leaf ``leaf_idx [B]`` of every tree under every model: one
    ``env.transition`` over the ``[B, A, M]`` children (reference:
    robust.py:42-50 over deterministic.py:28-65), written at rows
    ``base .. base + A``. In place on the tensors of ``tree``."""
    A = num_actions
    _, terminal_reward, one_minus_gamma, discount = scalars
    B, _, M = tree.reward.shape
    device = leaf_idx.device
    rows = torch.arange(B, device=device)
    block = slice(base, base + A)
    offsets = torch.arange(A, device=device)

    def fan_out(x):  # [B, M, ...] -> [B * A * M, ...] in (tree, action, model) order
        return x[:, None].expand((B, A) + x.shape[1:]).reshape((B * A * M,) + x.shape[2:])

    leaf_state = type(tree.states)(*(fan_out(x[rows, leaf_idx]) for x in tree.states))
    actions = offsets[None, :, None].expand(B, A, M).reshape(-1)
    out = env.transition(params_rows, leaf_state, actions, None, env.null_noise(B * A * M, device))

    d = tree.depth[rows, leaf_idx] + 1
    reward = out.reward.to(torch.float32).reshape(B, A, M)
    done = out.terminated.reshape(B, A, M) | tree.done[rows, leaf_idx][:, None]
    # value_lower + gamma ** (d - 1) * reward is one fused multiply-add in JAX
    vl = fma(discount[d - 1][:, None, None], reward, tree.value_lower[rows, leaf_idx][:, None])
    horizon_term = discount[d][:, None, None]
    vu = vl + horizon_term / one_minus_gamma
    terminal_value = vl + terminal_reward * horizon_term / one_minus_gamma
    vl = torch.where(done, terminal_value, vl)
    vu = torch.where(done, terminal_value, vu)

    for arena, new in zip(tree.states, out.state):
        arena[:, block] = new.reshape((B, A, M) + new.shape[1:])
    tree.parent[:, block] = leaf_idx[:, None]
    tree.action[:, block] = offsets
    tree.depth[:, block] = d[:, None]
    tree.children[rows, leaf_idx] = base + offsets
    tree.reward[:, block] = reward
    tree.done[:, block] = done
    tree.value_lower[:, block] = vl
    tree.value_upper[:, block] = vu
    tree.leaf[rows, leaf_idx] = False
    tree.leaf[:, block] = True
    tree.used.add_(A)
    return tree


def _worst_child_best(values, cvalid, cidx):
    """``[B, N]``: per node, the max over its children of the min over models."""
    B, N, A = cvalid.shape
    worst = values.amin(dim=2)
    return torch.where(cvalid, worst.gather(1, cidx).reshape(B, N, A), -torch.inf).amax(dim=2)


def _backup(tree: RobustTree, max_sweeps: int) -> RobustTree:
    """Interior bounds: each interior node holds, in every model's row, the
    max over its children of the min over models of the child's bound
    (reference RobustNode, robust.py:42-50). The JAX package backs up along
    the expanded leaf's path after every expansion; the selection reads leaf
    bounds only, which the backup never writes, so the same values come out
    of one bottom-up fixed point after the rounds. Stops once a sweep changes
    nothing (about the tree depth)."""
    B, N, A = tree.children.shape
    cvalid = tree.children >= 0
    cidx = tree.children.clamp(min=0).reshape(B, N * A)
    interior = cvalid.any(dim=2)[:, :, None]
    vl, vu = tree.value_lower, tree.value_upper
    for _ in range(max_sweeps):
        nvl = torch.where(interior, _worst_child_best(vl, cvalid, cidx)[:, :, None], vl)
        nvu = torch.where(interior, _worst_child_best(vu, cvalid, cidx)[:, :, None], vu)
        changed = ((nvl != vl) | (nvu != vu)).any()
        vl, vu = nvl, nvu
        if not bool(changed):
            break
    return tree._replace(value_lower=vl, value_upper=vu)


def _model_rows(params_ensemble, batch: int, num_actions: int, num_models: int):
    """Every field of the ``[M]``-stacked params repeated for the
    ``[B, A, M]`` rows of an expansion: row r takes model ``r % M``."""
    model = torch.arange(num_models).repeat(batch * num_actions)
    return type(params_ensemble)(*(field[model.to(field.device)] for field in params_ensemble))


def robust_opd_plan(env: FunctionalEnv, params_ensemble, states0, generator: torch.Generator | None,
                    num_actions: int, num_models: int, expansions: int, gamma: float,
                    terminal_reward: float = 0.0, plan_capacity: int = 32, noise=None,
                    device="cuda"):
    """OPD with vector node values over M models for B trees at once;
    selection and backup aggregate with the min over models (reference
    RobustNode, robust.py:42-50).

    ``params_ensemble``: env params with a leading ``[M]`` axis on every field.
    ``states0``: initial env states ``[B, M, ...]`` (each tree's state under
    each model). ``noise`` is Gumbel noise ``[plan_capacity, B, A]`` that
    breaks the ties of the plan's descent; without it, it is drawn from
    ``generator``. Returns ``(actions [B, P] with -1 past the plan,
    lengths [B], RobustTree)``.
    """
    device = resolve_device(device)
    if noise is None and generator is None:
        raise ValueError("robust_opd_plan needs a generator or noise")
    A, M = num_actions, num_models
    params_ensemble = params_to(params_ensemble, device)
    states0 = params_to(states0, device)
    B = states0[0].shape[0]
    capacity = 1 + expansions * A
    tree = _init_tree(states0, capacity, A, M)
    scalars = _scalars(gamma, terminal_reward, capacity, device)
    params_rows = _model_rows(params_ensemble, B, A, M)
    for i in range(expansions):
        scores = torch.where(tree.leaf, tree.value_upper.amin(dim=2), -torch.inf)
        # first max == earliest-created leaf, as the JAX package's argmax
        leaf_idx = scores.argmax(dim=1)
        tree = _expand(env, params_rows, tree, leaf_idx, 1 + i * A, scalars, A)
    tree = _backup(tree, max_sweeps=expansions + 1)
    plan_view = SimpleNamespace(children=tree.children, value_lower=tree.value_lower.amin(dim=2))
    actions, lengths = _greedy_plan(plan_view, generator, plan_capacity,
                                    None if noise is None else noise_tensor(noise, device))
    return actions, lengths, tree


class DiscreteRobustPlannerAgent(AbstractTreeSearchAgent):
    """DROP (reference: robust.py:53-71), planning one tree (B = 1). The
    model ensemble comes from the ``models`` (or the corpus's
    ``envs_preprocessors``) preprocessor lists applied to the true env, or
    from an explicit ``params_ensemble`` set by the caller."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(dict(budget=100, models=[]))
        return config

    def make_planner(self):
        self.params_ensemble = None

    def ensemble(self, env):
        """Env params stacked over the model axis. A model is a list of
        preprocessor configs, or one config (``MergeEnv/agents/
        DiscreteRobustPlannerAgent.json`` lists bare configs; the JAX package
        iterates such a dict's keys and fails)."""
        if self.params_ensemble is not None:
            return self.params_ensemble
        model_specs = self.config.get("models") or self.config.get("envs_preprocessors") or []
        variants = [preprocess_env(env, [spec] if isinstance(spec, dict) else spec).params
                    for spec in model_specs] or [env.params]
        return stack_params(variants)

    def planner_plan(self, env, observation):
        functional = env.functional
        num_actions = functional.action_space.n
        params_ensemble = self.ensemble(env)
        M = params_ensemble[0].shape[0]
        states0 = type(env.state)(*(x.unsqueeze(1).expand((x.shape[0], M) + x.shape[1:])
                                    for x in env.state))
        expansions = max(int(self.config["budget"]) // num_actions, 1)
        actions, lengths, tree = robust_opd_plan(
            functional, params_ensemble, states0, self.generator, num_actions=num_actions,
            num_models=M, expansions=expansions, gamma=float(self.config["gamma"]),
            terminal_reward=float(self.config["terminal_reward"]),
            plan_capacity=min(max(expansions, 1), 64), device=self.device)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])


class IntervalRobustPlannerAgent(AbstractAgent):
    """IRP (reference: robust.py:74-108): plans with its sub-agent in the env
    through ``env_preprocessors``."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.sub_agent = load_agent(self.config["sub_agent_path"] or self.config["sub_agent"],
                                    env, device=device)

    @classmethod
    def default_config(cls):
        return dict(sub_agent_path="", sub_agent={"__class__": "DeterministicPlannerAgent"},
                    env_preprocessors=[])

    def act(self, observation):
        return self.plan(observation)[0]

    def plan(self, observation):
        self.sub_agent.env = preprocess_env(self.env, self.config["env_preprocessors"])
        return self.sub_agent.plan(observation)

    def reset(self):
        return self.sub_agent.reset()

    def seed(self, seed=None):
        return self.sub_agent.seed(seed)

    def save(self, filename):
        return self.sub_agent.save(filename)

    def load(self, filename):
        return self.sub_agent.load(filename)

    def record(self, state, action, reward, next_state, done, info):
        return self.sub_agent.record(state, action, reward, next_state, done, info)
