"""Monte-Carlo Tree Search with UCT-style exploration, batch-first over trees.

Port of ``rl_agents_tpu/agents/tree_search/mcts.py`` (reference:
tree_search/mcts.py:100-305). Each episode descends every one of B trees by
the selection score ``value + temperature * |children| * prior / (count + 1)``
(mcts.py:275-286), expands the reached leaf with prior probabilities, rolls
the rollout policy out to the horizon (mcts.py:160-177) and backs the
discounted return up the branch (mcts.py:248-265).

Where the JAX package vmaps a single-tree program with ``while_loop``s, this
one carries a leading tree axis on every arena field, indexes rows directly
with ``(arange(B), node)`` and runs each data-dependent loop as a fixed number
of masked steps: a descent is at most ``horizon`` steps and a backup at most
``horizon + 1``. Slots are allocated in order with a ``used`` counter per
tree, as in the JAX package's single-tree planner. Nothing inside the episode
loop reads a value back to the host.

Randomness is Gumbel noise: an argmax over ``logits + noise`` breaks UCT ties
and draws rollout actions. A stochastic env's own draw of each step
(``env_noise``) is laid out as the JAX package splits a key for every env
step of the descent and of the rollout. The caller may inject either;
otherwise it is drawn from a ``torch.Generator``.

Budget allocation into (episodes, horizon) follows OLOP (mcts.py:116-118).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import (
    AbstractTreeSearchAgent,
    allocation,
    arena_subtree_gather,
)
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import gumbel, noise_tensor  # noqa: F401 (re-exported)


class MCTSTree(NamedTuple):
    parent: Any     # [B, N] i64
    children: Any   # [B, N, A] i64, -1 when absent
    count: Any      # [B, N] i64
    value: Any      # [B, N] f32
    prior: Any      # [B, N] f32
    used: Any       # [B] i64


def make_prior_fn(policy_config: dict, num_actions: int) -> torch.Tensor:
    """Prior/rollout policy probability vectors (reference: mcts.py:33-97)."""
    ptype = policy_config.get("type", "random_available")
    if ptype in ("random", "random_available"):
        probs = np.ones(num_actions) / num_actions
    elif ptype == "preference":
        action = policy_config["action"]
        ratio = policy_config.get("ratio", 2)
        probs = np.ones(num_actions) / (num_actions - 1 + ratio)
        probs[action] *= ratio
    else:
        raise ValueError(f"Unknown policy type {ptype}")
    return torch.tensor(probs, dtype=torch.float32)


def discount_table(gamma: float, size: int, device) -> torch.Tensor:
    """``gamma ** k`` for k < size as float32, tabulated on the host with
    scalar float32 ``powf``: XLA's ``pow`` rounds as it does, while vectorized
    pows round some powers differently."""
    g32 = np.float32(gamma)
    return torch.tensor([g32 ** np.float32(k) for k in range(size)], dtype=torch.float32,
                        device=device)


def _masked_random_argmax(noise, scores, mask):
    """Random tie-breaking argmax over masked entries of ``scores [B, A]``
    (reference: Node.random_argmax, abstract.py:295-311; ties by exact
    equality with the max), the tie broken by Gumbel ``noise [B, A]``."""
    vals = torch.where(mask, scores, -torch.inf)
    ties = mask & (vals == vals.amax(dim=1, keepdim=True))
    return (torch.where(ties, 0.0, -torch.inf) + noise).argmax(dim=1)


def _init_mcts_tree(batch: int, capacity: int, num_actions: int, device) -> MCTSTree:
    B, N, A = batch, capacity, num_actions
    return MCTSTree(
        parent=torch.full((B, N), -1, dtype=torch.int64, device=device),
        children=torch.full((B, N, A), -1, dtype=torch.int64, device=device),
        count=torch.zeros((B, N), dtype=torch.int64, device=device),
        value=torch.zeros((B, N), dtype=torch.float32, device=device),
        prior=torch.ones((B, N), dtype=torch.float32, device=device),
        used=torch.ones((B,), dtype=torch.int64, device=device),
    )


def _where_state(mask, new, old):
    """Per-tree select between two state NamedTuples."""
    return type(old)(*(torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                       for n, o in zip(new, old)))


def env_noise_pair(env_noise, device):
    """``(descend, rollout)`` env draws, each ``[episodes, H, B, ...]``, as
    tensors on ``device``; ``(None, None)`` when none is injected."""
    if env_noise is None:
        return None, None
    return tuple(noise_tensor(n, device) for n in env_noise)


def step_noise(env_noise, episode: int, step: int):
    """The env's draw at ``step`` of ``episode``, or None (then the env draws
    from the generator)."""
    return None if env_noise is None else env_noise[episode, step]


def _mcts_episodes(env, params, tree: MCTSTree, states0, generator, prior_probs, rollout_probs,
                   num_actions, episodes, horizon, gamma, temperature, noise, env_noise=None):
    """The MCTS episode loop (descend/expand/rollout/backup), in place on the
    tensors of ``tree``."""
    A, H, E = num_actions, horizon, episodes
    parent, children, count, value, prior, used = tree
    B, N = parent.shape
    device = parent.device
    f32 = torch.float32
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    discount = discount_table(gamma, 2 * H, device)
    temperature = torch.tensor(temperature, dtype=f32, device=device)
    prior_probs = prior_probs.to(device=device, dtype=f32)
    rollout_logits = torch.log(rollout_probs.to(device=device, dtype=f32))
    if noise is not None:
        descend_noise, rollout_noise = (noise_tensor(n, device) for n in noise)
    descend_env, rollout_env = env_noise_pair(env_noise, device)

    for episode in range(E):
        if noise is None:
            if generator is None:
                raise ValueError("mcts_plan needs a generator or noise")
            descend_g, rollout_g = gumbel((2, H, B, A), generator, device)
        else:
            descend_g, rollout_g = descend_noise[episode], rollout_noise[episode]

        # ---- descend: at most H steps; a tree that stopped keeps its place
        node = torch.zeros(B, dtype=torch.int64, device=device)
        depth = torch.zeros(B, dtype=torch.int64, device=device)
        total = torch.zeros(B, dtype=f32, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        state = states0
        for step in range(H):
            ch = children[rows, node]
            active = (ch[:, 0] >= 0) & (depth < H) & ~terminal
            valid = ch >= 0
            chs = ch.clamp(min=0)
            n_children = valid.sum(dim=1, keepdim=True).to(f32)
            scores = value.gather(1, chs) + temperature * n_children * prior.gather(1, chs) / (
                count.gather(1, chs).to(f32) + 1.0)
            action = _masked_random_argmax(descend_g[step], scores, valid)
            out = env.transition(params, state, action, generator,
                                 step_noise(descend_env, episode, step))
            # total + gamma ** depth * reward is one fused multiply-add in the JAX package
            new_total = fma(discount[depth], out.reward.to(f32), total)
            node = torch.where(active, ch.gather(1, action[:, None]).squeeze(1), node)
            state = _where_state(active, out.state, state)
            total = torch.where(active, new_total, total)
            terminal = terminal | (active & out.terminated)
            depth = depth + active

        # ---- expand (reference: mcts.py:151-154)
        is_leaf = children[rows, node, 0] < 0
        do_expand = is_leaf & (depth < H) & (~terminal | (node == 0))
        expand_a = do_expand[:, None]
        child_ids = used[:, None] + offsets
        children[rows, node] = torch.where(expand_a, child_ids, children[rows, node])
        # trees that do not expand may hold ids past the end: clamp, and write
        # the old values back there
        slots = child_ids.clamp(max=N - 1)
        parent.scatter_(1, slots, torch.where(expand_a, node[:, None].expand(B, A),
                                              parent.gather(1, slots)))
        prior.scatter_(1, slots, torch.where(expand_a, prior_probs.expand(B, A),
                                             prior.gather(1, slots)))
        used += torch.where(do_expand, A, 0)

        # ---- rollout (reference: mcts.py:160-177): H steps, live until the
        # horizon or a terminal state
        roll_state, h, rolled, roll_terminal = state, depth, total, terminal
        for step in range(H):
            action = (rollout_logits + rollout_g[step]).argmax(dim=1)
            out = env.transition(params, roll_state, action, generator,
                                 step_noise(rollout_env, episode, step))
            live = (h < H) & ~roll_terminal
            rolled = rolled + torch.where(live, discount[h] * out.reward.to(f32), 0.0)
            roll_state = _where_state(live, out.state, roll_state)
            roll_terminal = roll_terminal | (live & out.terminated)
            h = h + 1
        total = torch.where(terminal, total, rolled)

        # ---- backup (reference: mcts.py:248-265): the leaf lies at depth <= H
        n = node
        for _ in range(H + 1):
            on_path = n >= 0
            at = n.clamp(min=0)
            new_count = count[rows, at] + 1
            old_value = value[rows, at]
            new_value = old_value + (total - old_value) / new_count.to(f32)
            count[rows, at] = torch.where(on_path, new_count, count[rows, at])
            value[rows, at] = torch.where(on_path, new_value, old_value)
            n = torch.where(on_path, parent[rows, at], n)
    return MCTSTree(parent, children, count, value, prior, used)


def _extract_plan(tree: MCTSTree, horizon: int):
    """Plan extraction (reference: mcts.py:212-218 selection_rule): best visit
    count, ties broken by value."""
    B = tree.parent.shape[0]
    device = tree.parent.device
    node = torch.zeros(B, dtype=torch.int64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(horizon):
        ch = tree.children[torch.arange(B, device=device), node]
        valid = ch >= 0
        chs = ch.clamp(min=0)
        counts = torch.where(valid, tree.count.gather(1, chs), -1)
        tie = valid & (counts == counts.amax(dim=1, keepdim=True))
        action = torch.where(tie, tree.value.gather(1, chs), -torch.inf).argmax(dim=1)
        live = live & valid.any(dim=1)
        node = torch.where(live, ch.gather(1, action[:, None]).squeeze(1), node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    return actions, (actions >= 0).sum(dim=1)


def mcts_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
              prior_probs, rollout_probs, num_actions: int, episodes: int, horizon: int,
              gamma: float, temperature: float, noise=None, env_noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim). Returns ``(actions [B, H] with -1 past the plan, lengths [B],
    MCTSTree)``.

    ``noise`` is a pair of Gumbel tensors ``(descend, rollout)``, each
    ``[episodes, H, B, A]``: ``descend[e, d]`` breaks the UCT ties of the
    descent step at depth ``d`` and ``rollout[e, i]`` draws the ``i``-th
    rollout action of episode ``e``. Without it both are drawn from
    ``generator``.

    ``env_noise`` is a pair ``(descend, rollout)`` of a stochastic env's own
    draws, each ``[episodes, H, B, ...]`` with the step noise the env's
    ``step`` takes: ``descend[e, d]`` for the transition at depth ``d`` of the
    descent, ``rollout[e, i]`` for the ``i``-th rollout step (the JAX package
    splits one key for each). Without it the env draws from ``generator``.
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    B = states0[0].shape[0]
    tree = _init_mcts_tree(B, 1 + episodes * num_actions, num_actions, device)
    tree = _mcts_episodes(env, params, tree, states0, generator, prior_probs, rollout_probs,
                          num_actions, episodes, horizon, gamma, temperature, noise, env_noise)
    actions, lengths = _extract_plan(tree, horizon)
    return actions, lengths, tree


def mcts_plan_continue(env: FunctionalEnv, params, tree: MCTSTree, states0,
                       generator: torch.Generator | None, prior_probs, rollout_probs,
                       num_actions: int, episodes: int, horizon: int, gamma: float,
                       temperature: float, noise=None, env_noise=None, device="cuda"):
    """Continue MCTS in carried (re-rooted) arenas, the reference's plan()
    after step_by_prior (mcts.py:179-200): episodes descend from the *current*
    env state through the carried statistics. Each arena must have spare
    capacity >= episodes * num_actions. The argument's tensors are not
    written."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    tree = MCTSTree(*(t.to(device).clone() for t in tree))
    tree = _mcts_episodes(env, params, tree, states0, generator, prior_probs, rollout_probs,
                          num_actions, episodes, horizon, gamma, temperature, noise, env_noise)
    actions, lengths = _extract_plan(tree, horizon)
    return actions, lengths, tree


def mcts_step_by_prior(tree: MCTSTree, action, num_actions: int, out_capacity: int,
                       regularization: float = 0.5):
    """Re-root each arena at the chosen child and convert visit counts to
    priors (reference: mcts.py:192-200 step_by_prior +
    convert_visits_to_prior_in_branch, mcts.py:288-301): for every node in the
    carried subtree, ``prior = (1-reg)*(count+1)/sum(count+1) + reg/|children|``
    over its sibling block, then all counts reset to zero; values are kept.
    ``action`` is an int or ``[B]``.

    Returns ``(new_tree, valid [B])``; ``valid`` is False where the action was
    never explored from the root.
    """
    del num_actions  # the arena's own width decides
    f32 = torch.float32
    B, N, A = tree.children.shape
    old_of_new, new_id, used, slot, valid = arena_subtree_gather(
        tree.parent, tree.children, tree.used, action, out_capacity)

    def take(x, fill):
        if x.dim() == 2:
            return torch.where(slot, x.gather(1, old_of_new), fill)
        return torch.where(slot[:, :, None],
                           x.gather(1, old_of_new[:, :, None].expand(-1, -1, A)), fill)

    parent = take(new_id.gather(1, tree.parent.clamp(min=0)), -1)
    parent[:, 0] = -1
    renamed = new_id.gather(1, tree.children.clamp(min=0).reshape(B, N * A)).reshape(B, N, A)
    children = take(torch.where(tree.children >= 0, renamed, -1), -1)
    count = take(tree.count, 0)
    value = take(tree.value, 0.0)
    prior = take(tree.prior, 1.0)

    # Visit counts -> priors, computed from each node's sibling block.
    sib = children.gather(1, parent.clamp(min=0)[:, :, None].expand(-1, -1, A))
    sib_valid = sib >= 0
    sib_counts = torch.where(sib_valid, count.gather(1, sib.clamp(min=0).reshape(B, -1))
                             .reshape(sib.shape), 0)
    total = (sib_counts + sib_valid).sum(dim=2).to(f32)
    n_sib = sib_valid.sum(dim=2).to(f32)
    reg = torch.tensor(regularization, dtype=f32, device=count.device)
    converted = ((1 - reg) * (count + 1).to(f32) / torch.clamp(total, min=1.0)
                 + reg / torch.clamp(n_sib, min=1.0))
    prior = torch.where((parent >= 0) & slot, converted, prior)
    return MCTSTree(parent=parent, children=children, count=torch.zeros_like(count),
                    value=value, prior=prior, used=used), valid


def mcts_grow_arena(tree: MCTSTree, extra: int) -> MCTSTree:
    """Pad each arena with ``extra`` unallocated slots for continued planning."""
    def pad(x, fill):
        return torch.cat([x, torch.full((x.shape[0], extra) + x.shape[2:], fill, dtype=x.dtype,
                                        device=x.device)], dim=1)

    return MCTSTree(parent=pad(tree.parent, -1), children=pad(tree.children, -1),
                    count=pad(tree.count, 0), value=pad(tree.value, 0),
                    prior=pad(tree.prior, 1), used=tree.used)


def mcts_plan_batch(env, params, states0, generator, prior_probs, rollout_probs,
                    num_actions, episodes, horizon, gamma, temperature, noise=None,
                    env_noise=None, device="cuda"):
    """Batched MCTS over the leading tree axis: the fused planner of
    ``mcts_fused.py``, whose noise layouts (``[episodes, H, 2, A, B]``, and
    ``[episodes, H, B, ...]`` for the env) it takes."""
    from rl_agents_torch.agents.tree_search.mcts_fused import mcts_plan_batch_fused

    return mcts_plan_batch_fused(env, params, states0, generator, prior_probs, rollout_probs,
                                 num_actions=num_actions, episodes=episodes, horizon=horizon,
                                 gamma=gamma, temperature=temperature, noise=noise,
                                 env_noise=env_noise, device=device)


def mcts_plan_batch_vmap(env, params, states0, generator, prior_probs, rollout_probs,
                         num_actions, episodes, horizon, gamma, temperature, noise=None,
                         env_noise=None, device="cuda"):
    """The reference loop structure over a batch of trees, kept for
    cross-validation against the fused planner. The JAX package vmaps its
    single-tree ``mcts_plan`` here; this package's ``mcts_plan`` is batch-first
    already."""
    return mcts_plan(env, params, states0, generator, prior_probs, rollout_probs,
                     num_actions=num_actions, episodes=episodes, horizon=horizon, gamma=gamma,
                     temperature=temperature, noise=noise, env_noise=env_noise, device=device)


class MCTSAgent(AbstractTreeSearchAgent):
    """MCTS/UCT agent (reference: mcts.py:12-31), planning one tree (B = 1).
    Supports ``step_strategy: "prior"``: the arena is re-rooted between env
    steps with visit counts converted to priors, and the next plan continues
    in the carried tree (reference: mcts.py:186-200)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({
            "budget": 100,
            "horizon": None,
            "episodes": None,
            "prior_policy": {"type": "random_available"},
            "rollout_policy": {"type": "random_available"},
            "temperature": None,
            "closed_loop": False,
            "subtree_carry": None,
        })
        return config

    def make_planner(self):
        self.carried_tree = None  # arena carried across steps ("prior" strategy)
        if not self.config.get("horizon"):
            self.config["episodes"], self.config["horizon"] = allocation(
                self.config["budget"], self.config["gamma"])
        elif not self.config.get("episodes"):
            self.config["episodes"] = max(self.config["budget"] // self.config["horizon"], 1)
        if self.config.get("temperature") is None:
            self.config["temperature"] = 2 / (1 - self.config["gamma"])
        num_actions = self.env.action_space.n
        self.prior_probs = make_prior_fn(self.config["prior_policy"], num_actions)
        self.rollout_probs = make_prior_fn(self.config["rollout_policy"], num_actions)

    def planner_plan(self, env, observation):
        functional = env.functional
        if self.config.get("closed_loop"):
            from rl_agents_torch.agents.tree_search.mcts_closed_loop import (
                mcts_closed_loop_plan,
            )

            action, tree = mcts_closed_loop_plan(
                functional, env.params, env.state, self.generator, self.prior_probs,
                self.rollout_probs, num_actions=functional.action_space.n,
                episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
                gamma=float(self.config["gamma"]), temperature=float(self.config["temperature"]),
                width=int(self.config.get("max_next_states_count", 8)), device=self.device)
            self.last_plan_data = tree
            return [int(action[0])]
        kwargs = dict(num_actions=functional.action_space.n,
                      episodes=int(self.config["episodes"]),
                      horizon=int(self.config["horizon"]),
                      gamma=float(self.config["gamma"]),
                      temperature=float(self.config["temperature"]),
                      device=self.device)
        if self.carried_tree is not None:
            actions, lengths, tree = mcts_plan_continue(
                functional, env.params, self.carried_tree, env.state, self.generator,
                self.prior_probs, self.rollout_probs, **kwargs)
        else:
            actions, lengths, tree = mcts_plan(
                functional, env.params, env.state, self.generator,
                self.prior_probs, self.rollout_probs, **kwargs)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])

    def planner_step_tree(self, actions):
        if self.config["step_strategy"] != "prior" or self.config.get("closed_loop"):
            return
        tree = self.last_plan_data
        if tree is None or not actions:
            self.carried_tree = None
            return
        num_actions = tree.children.shape[2]
        episodes = int(self.config["episodes"])
        carry = int(self.config.get("subtree_carry") or episodes * num_actions)
        new_tree, valid = mcts_step_by_prior(
            tree, int(actions[0]), num_actions=num_actions, out_capacity=carry)
        if bool(valid[0]):
            self.carried_tree = mcts_grow_arena(new_tree, episodes * num_actions)
        else:  # never-explored action: plan from scratch (abstract.py:203-206)
            self.carried_tree = None

    def reset(self):
        super().reset()
        self.carried_tree = None
