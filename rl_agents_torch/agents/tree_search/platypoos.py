"""PlaTyPOOS: scale-free adaptive planning for deterministic dynamics.

Port of ``rl_agents_tpu/agents/tree_search/platypoos.py`` (reference:
tree_search/platypoos.py:11-192): layer-by-layer exploration with
power-of-two evaluation schedules (platypoos.py:30-65), a cross-validation
pass over the per-scale best candidates (platypoos.py:67-77), and plan
extraction by following the best candidate to the root (platypoos.py:79-89).

Each depth layer is a struct of arrays: the env states stacked as tensors on
the agent's device, and numpy statistics (value, count, reward sum, done) and
tree pointers (parent, child base) on the host. The per-layer schedule is
host arithmetic in numpy; all evaluations of a layer run as one env step over
``[selected nodes x actions x evaluations]``, padded to power-of-two buckets
(platypoos.py:37-63), with each node's evaluation count enforced by a mask.

As in the JAX package, every action is expanded (the reference's
``range(1, n)`` skips action 0) and a node's terminal flag is the OR over
its samples; both coincide with the reference on deterministic envs.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def expand_batch(env, params, states, evals, generator, num_actions: int, max_evals: int):
    """Evaluate every action of every selected node ``evals[i]`` times.

    ``states`` is a state NamedTuple ``[M, ...]`` and ``evals [M]`` (0 pads).
    Returns the child states ``[M, A, ...]`` (of the first sample), the reward
    sums ``[M, A]`` and the terminal flags ``[M, A]`` over each node's
    evaluations. One env step over ``M * A * max_evals`` states."""
    M, A, E = evals.shape[0], num_actions, max_evals
    rep = type(states)(*(x.repeat_interleave(A * E, dim=0) for x in states))
    device = states[0].device
    actions = torch.arange(A, device=device).repeat_interleave(E).repeat(M)
    out = env.transition(params, rep, actions, generator)
    mask = torch.arange(E, device=device) < evals[:, None, None]
    reward = out.reward.to(torch.float32).reshape(M, A, E)
    cum_reward = (reward * mask).sum(dim=2)
    done = (out.terminated.reshape(M, A, E) & mask).any(dim=2)
    child_states = type(states)(*(x.reshape((M, A, E) + x.shape[1:])[:, :, 0]
                                  for x in out.state))
    return child_states, cum_reward, done


class _Layer:
    """All nodes at one depth, as arrays."""

    __slots__ = ("states", "value", "count", "cum_reward", "done", "parent", "action",
                 "child_base", "size", "depth", "gamma_pow")

    def __init__(self, depth: int, size: int, states, parent, action):
        self.depth = depth
        self.size = size
        self.states = states                       # state NamedTuple [size, ...]
        self.parent = parent                       # [size] index into the layer above
        self.action = action                       # [size] action from the parent
        self.value = np.zeros(size)
        self.count = np.zeros(size, np.int64)
        self.cum_reward = np.zeros(size)
        self.done = np.zeros(size, bool)
        self.child_base = np.full(size, -1, np.int64)  # base index into the layer below


class PlaTyPOOSAgent(AbstractTreeSearchAgent):
    """(reference: platypoos.py:189-192), planning one tree."""

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({"budget": 200, "horizon": None})
        return cfg

    def make_planner(self):
        self.num_actions = self.env.action_space.n
        self.gamma = self.config["gamma"]
        if not self.config.get("horizon"):
            expansion_budget = self.config["budget"] / self.num_actions
            self.config["horizon"] = max(int(np.floor(
                expansion_budget / (2 * (np.log2(max(expansion_budget, 2)) + 1) ** 2))), 2)
        self.candidates = {}
        self.openings = 0
        self.env_steps = 0  # env transitions run by the last plan, padding included

    # -- batched expansion ----------------------------------------------------

    def _expand(self, layer: _Layer, sel: np.ndarray, evals: np.ndarray,
                next_layer_rows: list | None):
        """Expand the nodes ``sel`` of ``layer`` with per-node evaluation
        counts, in one env step (reference: platypoos.py:135-166). Created
        child rows go to ``next_layer_rows``; where a node has children
        already (the cross-validation pass), their statistics are updated in
        place."""
        self.openings += int(evals.sum())
        active = (~layer.done[sel]) & (evals > 0)   # done nodes do not expand
        sel, evals = sel[active], evals[active]
        if sel.size == 0:
            return
        m_pad, e_pad = _pow2(len(sel)), _pow2(int(evals.max()))
        sel_pad = np.concatenate([sel, np.zeros(m_pad - len(sel), np.int64)])
        evals_pad = np.concatenate([evals, np.zeros(m_pad - len(sel), np.int64)])
        index = torch.as_tensor(sel_pad, device=self.device)
        states = type(layer.states)(*(x[index] for x in layer.states))
        child_states, cum, done = expand_batch(
            self.env_functional, self.env_params, states,
            torch.as_tensor(evals_pad, device=self.device), self.generator, self.num_actions,
            e_pad)
        self.env_steps += m_pad * self.num_actions * e_pad
        cum = cum.cpu().numpy().astype(np.float64)[:len(sel)]     # [M, A]
        done = done.cpu().numpy()[:len(sel)]

        A, g = self.num_actions, self.gamma
        for row, (i, n_evals) in enumerate(zip(sel, evals)):
            base = layer.child_base[i]
            if base < 0:
                if next_layer_rows is None:
                    continue  # cross-validation on a childless node: nothing to update
                # new children: the expansion row, materialised per layer
                layer.child_base[i] = len(next_layer_rows) * A
                next_layer_rows.append((i, row, child_states, cum[row], done[row], n_evals,
                                        layer))
            else:
                # existing children (cross-validation): update in place
                # (reference: platypoos.py:124-133, value from the live parent)
                child = self._layers[layer.depth + 1]
                idx = np.arange(base, base + A)
                child.cum_reward[idx] += cum[row]
                child.count[idx] += n_evals
                child.done[idx] |= done[row]
                child.value[idx] = layer.value[i] + g ** layer.depth * (
                    child.cum_reward[idx] / child.count[idx])

    @staticmethod
    def _materialize_layer(depth: int, rows, num_actions: int) -> _Layer:
        """The next layer's arrays from the deferred expansion rows."""
        A = num_actions
        size = len(rows) * A
        parent = np.repeat([r[0] for r in rows], A)
        action = np.tile(np.arange(A), len(rows))
        states = type(rows[0][2])(*(torch.cat([r[2][f][r[1]] for r in rows], dim=0)
                                    for f in range(len(rows[0][2]))))
        layer = _Layer(depth, size, states, parent, action)
        for k, (i, _row, _cs, cum, done, n_evals, parent_layer) in enumerate(rows):
            idx = slice(k * A, (k + 1) * A)
            layer.cum_reward[idx] = cum
            layer.count[idx] = n_evals
            layer.done[idx] = done
            # value = parent + gamma^(child depth - 1) * mean reward
            # (reference: platypoos.py:130-132)
            layer.value[idx] = parent_layer.value[i] + parent_layer.gamma_pow * (cum / n_evals)
        return layer

    # -- the planner ----------------------------------------------------------

    def planner_plan(self, env, observation):
        self.env_functional = env.functional
        self.env_params = env.params
        self.candidates, self.openings, self.env_steps = {}, 0, 0
        h_max, gamma, A = self.config["horizon"], self.gamma, self.num_actions

        root = _Layer(0, 1, env.state, np.array([-1]), np.array([-1]))
        self._layers = [root]

        # root expansion (reference: platypoos.py:94-97)
        rows: list = []
        root.gamma_pow = gamma ** 0  # child depth 1: gamma^(1 - 1)
        self._expand(root, np.array([0]), np.array([h_max], np.int64), rows)
        if not rows:
            return [0]
        self._layers.append(self._materialize_layer(1, rows, A))

        # exploration (reference: platypoos.py:30-65)
        for h in range(1, h_max):
            layer = self._layers[h]
            order = np.argsort(-layer.value, kind="stable")
            p_top = max(int(np.floor(np.log2(
                h_max / max(np.ceil(h ** 2 * gamma ** (2 * h)), 1e-9)))), 0)
            to_expand, sel_evals, taken = [], [], np.zeros(layer.size, bool)
            for p in range(p_top, -1, -1):
                nodes_count = int(np.floor(h_max / h * np.ceil(h * 2 ** p * gamma ** (2 * h))))
                evaluations = int(np.ceil(h * 2 ** p * gamma ** (2 * h)))
                min_visits = int(np.ceil((h - 1) * 2 ** p * gamma ** (2 * (h - 1))))
                for i in order:
                    if layer.count[i] > min_visits and not taken[i]:
                        taken[i] = True
                        to_expand.append((i, p))
                        sel_evals.append(evaluations)
                    if len(to_expand) >= nodes_count:
                        break
            rows = []
            layer.gamma_pow = gamma ** h  # children at depth h + 1
            if to_expand:
                sel = np.array([i for i, _ in to_expand], np.int64)
                self._expand(layer, sel, np.array(sel_evals, np.int64), rows)
            for i, p in to_expand:
                if p not in self.candidates or \
                        layer.value[i] > self._cand_value(self.candidates[p]):
                    self.candidates[p] = (h, i)
            if rows:
                self._layers.append(self._materialize_layer(h + 1, rows, A))
            else:
                break

        if not self.candidates:
            return [0]

        # cross-validation (reference: platypoos.py:67-77)
        for depth, i in list(self.candidates.values()):
            d, node = depth, i
            while d >= 0:
                layer = self._layers[d]
                evaluations = int(np.floor(
                    (d + 1) * 5 * h_max * gamma ** (2 * d) * (1 - gamma ** 2) ** 2))
                self._expand(layer, np.array([node]), np.array([evaluations], np.int64), None)
                node = int(layer.parent[node]) if d > 0 else -1
                d -= 1

        # plan extraction (reference: platypoos.py:79-89)
        depth, i = max(self.candidates.values(), key=self._cand_value)
        actions = []
        while depth > 0:
            layer = self._layers[depth]
            actions.insert(0, int(layer.action[i]))
            i = int(layer.parent[i])
            depth -= 1
        self.last_plan_data = None
        return actions or [0]

    def _cand_value(self, cand):
        depth, i = cand
        return self._layers[depth].value[i]
