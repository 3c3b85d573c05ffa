"""Open-Loop Optimistic Planning (OLOP / KL-OLOP), batch-first over trees.

Port of ``rl_agents_tpu/agents/tree_search/olop.py`` (reference:
tree_search/olop.py:11-200). The budget is split into M episodes of horizon
L; each episode descends the action-sequence tree of every one of B trees by
maximal B-value, expanding leaves on the way, updates the visited nodes'
reward upper confidence bounds, then backs the sequence B-values
``value_upper = mu_ucb + gamma * max(children)`` up to the root.

Where the JAX package vmaps a single-tree program, this one carries a
leading tree axis on every arena field and indexes rows directly with
``(arange(B), node)``; the one-hot masked access of the JAX package exists
only for the TPU. The KL-UCB of every node an episode visited is one
``kl_bound_indexed_`` call over that episode's path ``[H, B]``, after its
descent: on a CUDA device that is one launch of the hand-written kernel per
episode. Nothing inside the episode loop reads a value back to the host.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent, allocation
from rl_agents_torch.envs.base import FunctionalEnv, params_to
from rl_agents_torch.ops.kl_bound import kl_bound_indexed_
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS, fma
from rl_agents_torch.utils.noise import noise_tensor


def parse_threshold(spec, default_coeff: float = 4.0) -> float:
    """Parse a threshold spec: a number, or the reference's legacy
    "<c>*np.log(time)" string form (no eval)."""
    if isinstance(spec, (int, float)):
        return float(spec)
    if isinstance(spec, str):
        m = re.fullmatch(r"\s*([\d.]+)\s*\*\s*np\.log\(\s*time\s*\)\s*", spec)
        if m:
            return float(m.group(1))
        raise ValueError(f"Unsupported threshold spec {spec!r}; use a coefficient c for c*log(time)")
    return default_coeff


class OLOPTree(NamedTuple):
    parent: Any       # [B, N] i64
    children: Any     # [B, N, A] i64
    depth: Any        # [B, N] i64
    count: Any        # [B, N] i64
    cum_reward: Any   # [B, N] f32
    mu_ucb: Any       # [B, N] f32
    value_upper: Any  # [B, N] f32  (sequence B-value)
    done: Any         # [B, N] bool
    used: Any         # [B] i64


def olop_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None = None, *,
              num_actions: int, episodes: int, horizon: int, gamma: float,
              threshold_coeff: float, ucb_type: str = "kullback-leibler",
              time_global: bool = True, continuation_uniform: bool = False,
              random_actions=None, env_noise=None, device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a leading
    batch dim). Returns ``(actions [B, H] with -1 past the plan, lengths [B],
    OLOPTree)``.

    ``continuation_uniform`` continues leaves with uniform random actions:
    ``random_actions`` ``[episodes, horizon, B]`` supplies them, else they are
    drawn from ``generator``. ``env_noise`` is a stochastic env's own noise
    for every step, ``[episodes, horizon, B, ...]``; without it the env draws
    from ``generator``.
    """
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    A, H, E = num_actions, horizon, episodes
    B = states0[0].shape[0]
    N = 1 + E * H * A
    i64, f32 = torch.int64, torch.float32
    # initial B-values (1 - gamma^(H+1-depth)) / (1 - gamma), tabulated on the
    # host with scalar float32 powf: vectorized pows (torch's, numpy's) round
    # some powers differently, and these values meet backed-up ones in exact
    # ties, so each rounding step decides which branch a descent takes
    g32 = np.float32(gamma)
    upper_table = torch.tensor(
        [(np.float32(1) - g32 ** np.float32(k)) / (np.float32(1) - g32) for k in range(H + 2)],
        dtype=f32, device=device)
    gamma = torch.tensor(g32, device=device)
    rows = torch.arange(B, device=device)
    path_rows = rows.expand(H, B)
    offsets = torch.arange(A, device=device)

    def init_upper(depth):
        return upper_table[H + 1 - depth]

    kl = ucb_type == "kullback-leibler"
    parent = torch.full((B, N), -1, dtype=i64, device=device)
    children = torch.full((B, N, A), -1, dtype=i64, device=device)
    depth = torch.zeros((B, N), dtype=i64, device=device)
    count = torch.zeros((B, N), dtype=i64, device=device)
    cum_reward = torch.zeros((B, N), dtype=f32, device=device)
    mu_ucb = torch.full((B, N), 1.0 if kl else torch.inf, dtype=f32, device=device)
    value_upper = torch.zeros((B, N), dtype=f32, device=device)
    value_upper[:, 0] = init_upper(torch.zeros((), dtype=i64, device=device))
    done = torch.zeros((B, N), dtype=torch.bool, device=device)
    used = torch.ones(B, dtype=i64, device=device)

    time = torch.arange(1, E + 1, dtype=f32, device=device) if not time_global \
        else torch.full((E,), float(E), dtype=f32, device=device)
    thresholds = threshold_coeff * torch.log(time)

    def update_reward_ucb(path, threshold):
        """mu_ucb of the path's nodes ``[H, B]`` from their statistics."""
        if kl:
            kl_bound_indexed_(mu_ucb, cum_reward, count, path, threshold,
                              iters=NEWTON_MAX_ITERATIONS, eps=1e-2)
            return
        # hoeffding: mu + sqrt(threshold / (2 n)) (the reference's hoeffding
        # branch is dormant, olop.py:153-158)
        cnt = count[path_rows, path].to(f32)
        safe = torch.clamp(cnt, min=1.0)
        bound = cum_reward[path_rows, path] / safe + torch.sqrt(threshold / (2.0 * safe))
        mu_ucb[path_rows, path] = torch.where(cnt == 0, torch.inf, bound)

    if continuation_uniform:
        if random_actions is None:
            if generator is None:
                raise ValueError("continuation_uniform needs a generator or random_actions")
            random_actions = torch.randint(0, A, (E, H, B), generator=generator,
                                           device=generator.device).to(device)
        if not isinstance(random_actions, torch.Tensor):
            random_actions = torch.tensor(np.asarray(random_actions))
        random_actions = random_actions.to(device=device, dtype=i64)
    else:
        random_actions = torch.zeros((E, H, B), dtype=i64, device=device)

    if env_noise is not None:
        env_noise = noise_tensor(env_noise, device)

    def child_values(values, ch, fill):
        """values[b, ch[b, a]] where ch >= 0, else ``fill``."""
        return torch.where(ch >= 0, values.gather(1, ch.clamp(min=0)), fill)

    path = torch.empty((H, B), dtype=i64, device=device)
    for episode in range(E):
        node = torch.zeros(B, dtype=i64, device=device)
        state = states0
        for h in range(H):
            # expand when leaf (reference: olop.py:79-82)
            is_leaf = children[rows, node, 0] < 0
            leaf_a = is_leaf[:, None]
            child_ids = used[:, None] + offsets
            children[rows, node] = torch.where(leaf_a, child_ids, children[rows, node])
            # a full arena puts non-leaf trees' ids past the end: clamp, and
            # write the old values back there
            slots = child_ids.clamp(max=N - 1)
            d = (depth[rows, node] + 1)[:, None].expand(B, A)
            parent.scatter_(1, slots, torch.where(leaf_a, node[:, None].expand(B, A),
                                                  parent.gather(1, slots)))
            depth.scatter_(1, slots, torch.where(leaf_a, d, depth.gather(1, slots)))
            value_upper.scatter_(1, slots, torch.where(leaf_a, init_upper(d),
                                                       value_upper.gather(1, slots)))
            used = used + torch.where(is_leaf, A, 0)

            ch = children[rows, node]
            ucb_action = child_values(value_upper, ch, -torch.inf).argmax(dim=1)
            action = torch.where(is_leaf, random_actions[episode, h], ucb_action)

            out = env.transition(params, state, action, generator,  # the observation is unused
                                 None if env_noise is None else env_noise[episode, h])
            child = ch.gather(1, action[:, None]).squeeze(1)
            # node reward statistics update (reference: olop.py:132-142)
            child_done = out.terminated | done[rows, child]
            reward = torch.where(child_done, 0.0, out.reward.to(f32))
            cum_reward[rows, child] = cum_reward[rows, child] + reward
            count[rows, child] = count[rows, child] + 1
            done[rows, child] = child_done
            path[h] = child
            node, state = child, out.state

        # the reference updates mu_ucb at every step of the descent
        # (olop.py:132-142); one update over the whole path after it is exact:
        # mu_ucb is read only by the backup below, and depth grows by one a
        # step, so the path visits each node once and its statistics are final
        update_reward_ucb(path, thresholds[episode])

        # backup B-values to the root (reference: olop.py:182-193); a leaf
        # lies at depth <= H, so H + 1 trips reach every root
        for _ in range(H + 1):
            active = node >= 0
            n = node.clamp(min=0)
            ch = children[rows, n]
            best_child = child_values(value_upper, ch, -torch.inf).amax(dim=1)
            mu_n = mu_ucb[rows, n]
            new_v = torch.where((ch >= 0).any(dim=1), fma(gamma, best_child, mu_n), mu_n)
            value_upper[rows, n] = torch.where(active, new_v, value_upper[rows, n])
            node = torch.where(active, parent[rows, n], node)

    # plan extraction: best count, ties by value_upper (olop.py:126-130)
    node = torch.zeros(B, dtype=i64, device=device)
    live = torch.ones(B, dtype=torch.bool, device=device)
    actions = []
    for _ in range(H):
        ch = children[rows, node]
        valid = ch >= 0
        counts = child_values(count, ch, -1)
        cvu = child_values(value_upper, ch, 0.0)
        tie = valid & (counts == counts.amax(dim=1, keepdim=True))
        action = torch.where(tie, cvu, -torch.inf).argmax(dim=1)
        child = ch.gather(1, action[:, None]).squeeze(1)
        live = live & valid.any(dim=1)
        node = torch.where(live, child, node)
        actions.append(torch.where(live, action, -1))
    actions = torch.stack(actions, dim=1)
    lengths = (actions >= 0).sum(dim=1)
    tree = OLOPTree(parent, children, depth, count, cum_reward, mu_ucb, value_upper, done, used)
    return actions, lengths, tree


class OLOPAgent(AbstractTreeSearchAgent):
    """OLOP / KL-OLOP agent (reference: olop.py:196-200)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({
            "budget": 100,
            "upper_bound": {
                "type": "kullback-leibler",
                "time": "global",
                "threshold": "4*np.log(time)",
            },
            "continuation_type": "zeros",
        })
        return config

    def make_planner(self):
        budget = max(self.env.action_space.n, self.config["budget"])
        self.config["episodes"], self.config["horizon"] = allocation(
            budget, self.config["gamma"])

    def planner_plan(self, env, observation):
        functional = env.functional
        ub = self.config["upper_bound"]
        if isinstance(ub, str):  # a bare bound name keeps the default threshold and time
            ub = dict(self.default_config()["upper_bound"], type=ub)
        actions, lengths, tree = olop_plan(
            functional, env.params, env.state, self.generator,
            num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]),
            threshold_coeff=parse_threshold(ub.get("threshold", 4.0)),
            ucb_type=ub.get("type", "kullback-leibler"),
            time_global=(ub.get("time", "global") == "global"),
            continuation_uniform=(self.config["continuation_type"] == "uniform"),
            device=self.device)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])
