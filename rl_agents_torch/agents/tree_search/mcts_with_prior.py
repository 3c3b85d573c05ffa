"""MCTS guided by another agent's policy as prior and rollout policy.

Port of ``rl_agents_tpu/agents/tree_search/mcts_with_prior.py`` (reference:
tree_search/mcts_with_prior.py:9-71): an MCTS whose expansion priors and
rollout action distributions come from a sub-agent's policy (a DQN under a
Boltzmann distribution by default). The prior is a tensor function
``prior_fn(prior_params, obs [B, ...]) -> probs [B, A]``, evaluated as one
forward over all B trees at every expansion and at every rollout step.

The planner is batch-first over B trees, as ``mcts.py``'s: each descent,
rollout and backup is a fixed number of masked steps. Randomness is Gumbel
noise, injected or drawn from a ``torch.Generator``: ``noise[0][e, d]``
breaks the descent's ties at depth d of episode e and ``noise[1][e, i]``
draws the i-th rollout action, ``argmax(log(max(p, 1e-12)) + noise)``, which
is ``jax.random.categorical`` of the same key. A stochastic env's own draws
are ``env_noise``, laid out as the JAX package splits a key for every env
step.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from rl_agents_torch.agents.tree_search.mcts import (
    MCTSAgent,
    MCTSTree,
    _extract_plan,
    _init_mcts_tree,
    _masked_random_argmax,
    _where_state,
    discount_table,
    env_noise_pair,
    step_noise,
)
from rl_agents_torch.envs.base import Discrete, FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma, recip
from rl_agents_torch.utils.noise import gumbel, noise_tensor


def _where_obs(mask, new, old):
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def mcts_prior_plan(env: FunctionalEnv, params, states0, obs0, generator: torch.Generator | None,
                    prior_params, prior_fn: Callable, num_actions: int, episodes: int,
                    horizon: int, gamma: float, temperature: float, noise=None, env_noise=None,
                    device="cuda"):
    """Plan B trees at once from ``states0`` (a state NamedTuple with a
    leading batch axis) whose observations are ``obs0 [B, ...]``, with the
    expansion priors and rollout distributions of ``prior_fn``. Returns
    ``(actions [B, H] with -1 past the plan, lengths [B], MCTSTree)``.
    ``noise`` is ``(descend, rollout)``, each ``[episodes, H, B, A]``; without
    it both are drawn from ``generator``. ``env_noise`` is ``(descend,
    rollout)``, each ``[episodes, H, B, ...]``, a stochastic env's own draw of
    each descent and rollout step; without it the env draws from
    ``generator``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    obs0 = torch.as_tensor(obs0).to(device)
    A, H, E = num_actions, horizon, episodes
    B = obs0.shape[0]
    f32 = torch.float32
    parent, children, count, value, prior, used = _init_mcts_tree(B, 1 + E * A, A, device)
    N = parent.shape[1]
    rows = torch.arange(B, device=device)
    offsets = torch.arange(A, device=device)
    discount = discount_table(gamma, 2 * H, device)
    temperature = torch.tensor(temperature, dtype=f32, device=device)
    if noise is not None:
        descend_noise, rollout_noise = (noise_tensor(n, device) for n in noise)
    descend_env, rollout_env = env_noise_pair(env_noise, device)
    forwards = 0

    for episode in range(E):
        if noise is None:
            if generator is None:
                raise ValueError("mcts_prior_plan needs a generator or noise")
            descend_g, rollout_g = gumbel((2, H, B, A), generator, device)
        else:
            descend_g, rollout_g = descend_noise[episode], rollout_noise[episode]

        # ---- descend: at most H steps, carrying each tree's observation
        node = torch.zeros(B, dtype=torch.int64, device=device)
        depth = torch.zeros(B, dtype=torch.int64, device=device)
        total = torch.zeros(B, dtype=f32, device=device)
        terminal = torch.zeros(B, dtype=torch.bool, device=device)
        state, obs = states0, obs0
        for step in range(H):
            ch = children[rows, node]
            active = (ch[:, 0] >= 0) & (depth < H) & ~terminal
            valid = ch >= 0
            chs = ch.clamp(min=0)
            n_children = valid.sum(dim=1, keepdim=True).to(f32)
            scores = value.gather(1, chs) + temperature * n_children * prior.gather(1, chs) / (
                count.gather(1, chs).to(f32) + 1.0)
            action = _masked_random_argmax(descend_g[step], scores, valid)
            out = env.step(params, state, action, generator,
                           step_noise(descend_env, episode, step))
            # total + gamma ** depth * reward is one fused multiply-add in the JAX package
            new_total = fma(discount[depth], out.reward.to(f32), total)
            node = torch.where(active, ch.gather(1, action[:, None]).squeeze(1), node)
            state = _where_state(active, out.state, state)
            obs = _where_obs(active, out.obs, obs)
            total = torch.where(active, new_total, total)
            terminal = terminal | (active & out.terminated)
            depth = depth + active

        # ---- expand with the prior at the reached observation
        probs = prior_fn(prior_params, obs).to(f32)
        forwards += 1
        is_leaf = children[rows, node, 0] < 0
        do_expand = is_leaf & (depth < H) & (~terminal | (node == 0))
        expand_a = do_expand[:, None]
        child_ids = used[:, None] + offsets
        children[rows, node] = torch.where(expand_a, child_ids, children[rows, node])
        slots = child_ids.clamp(max=N - 1)
        parent.scatter_(1, slots, torch.where(expand_a, node[:, None].expand(B, A),
                                              parent.gather(1, slots)))
        prior.scatter_(1, slots, torch.where(expand_a, probs, prior.gather(1, slots)))
        used += torch.where(do_expand, A, 0)

        # ---- rollout following the prior policy: H steps, live until the
        # horizon or a terminal state
        roll_state, roll_obs, h, rolled, roll_terminal = state, obs, depth, total, terminal
        for step in range(H):
            logits = torch.log(torch.clamp(prior_fn(prior_params, roll_obs).to(f32), min=1e-12))
            forwards += 1
            action = (logits + rollout_g[step]).argmax(dim=1)
            out = env.step(params, roll_state, action, generator,
                           step_noise(rollout_env, episode, step))
            live = (h < H) & ~roll_terminal
            rolled = rolled + torch.where(live, discount[h] * out.reward.to(f32), 0.0)
            roll_state = _where_state(live, out.state, roll_state)
            roll_obs = _where_obs(live, out.obs, roll_obs)
            roll_terminal = roll_terminal | (live & out.terminated)
            h = h + 1
        total = torch.where(terminal, total, rolled)

        # ---- backup: the leaf lies at depth <= H
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
    mcts_prior_plan.prior_forwards = forwards  # prior_fn calls of the last plan
    tree = MCTSTree(parent, children, count, value, prior, used)
    actions, lengths = _extract_plan(tree, H)
    return actions, lengths, tree


# the batch-first planner under the names of the JAX package's batch entry points
mcts_prior_plan_batch = mcts_prior_plan_batch_vmap = mcts_prior_plan


def dqn_prior(model: torch.nn.Module, temperature: float, obs_dim: int) -> Callable:
    """``prior_fn`` of a Q-network: ``softmax(Q(obs) / temperature)`` over the
    flattened observation cut to ``obs_dim`` features, the network evaluated
    on the parameters it is given."""
    scale = recip(temperature)  # the JAX package's q / temperature, a constant there

    def prior_fn(params, obs):
        x = obs.reshape(obs.shape[0], -1)[:, :obs_dim].to(torch.float32)
        with torch.no_grad():
            q = functional_call(model, params, (x,))
        return torch.softmax(q * scale, dim=-1)

    return prior_fn


def tabular_prior(table, obs):
    """``prior_fn`` of a per-state table ``[S, A]`` for index observations:
    the row of each tree's state, zeros for an index outside the table.

    A 1-D table ``[A]`` is the root vector the agent builds for a prior agent
    without ``state_action_value``. The JAX package's one-hot sum over its
    entries gives the whole vector at an index below A and zeros at A or
    above; the port keeps those zeros, a latent defect of the JAX package
    (ROADMAP.md §3)."""
    S = table.shape[0]
    index = obs.reshape(-1).to(torch.int64)
    inside = ((index >= 0) & (index < S))[:, None]
    if table.dim() == 1:
        return torch.where(inside, table.expand(index.shape[0], S), 0.0)
    return torch.where(inside, table[index.clamp(0, S - 1)], 0.0)


def root_prior(probs, obs):
    """``prior_fn`` that applies one action distribution ``[A]`` (or one per
    tree, ``[B, A]``) at every node."""
    return probs.expand(obs.shape[0], probs.shape[-1])


class MCTSWithPriorPolicyAgent(MCTSAgent):
    """(reference: mcts_with_prior.py:9-71) One tree (B = 1) a plan."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update({
            "prior_agent": {
                "__class__": "DQNAgent",
                "exploration": {"method": "Boltzmann"},
            },
        })
        return config

    def make_planner(self):
        from rl_agents_torch.factory import agent_factory

        super().make_planner()
        self.prior_agent = agent_factory(self.env, self.config["prior_agent"], device=self.device)
        if "model_save" in self.config["prior_agent"]:
            self.prior_agent.load(self.config["prior_agent"]["model_save"])
        self._temperature = self.config["prior_agent"].get("exploration", {}).get(
            "temperature", 0.5)
        if hasattr(self.prior_agent, "model") and hasattr(self.prior_agent, "train_state"):
            # a parametric prior (DQN), evaluated at every node
            # (reference: mcts_with_prior.py:47-53)
            obs_dim = int(np.prod(self.env.observation_space.shape or (1,)))
            self._prior_fn = dqn_prior(self.prior_agent.model, self._temperature, obs_dim)
            self._tabular_prior = False
        else:
            obs_space = getattr(self.env, "observation_space", None)
            self._index_obs = isinstance(obs_space, Discrete) or (
                hasattr(obs_space, "n") and not getattr(obs_space, "shape", None))
            # finite-MDP observations are state indices: the prior's
            # Boltzmann table is read at every node. Other observations (the
            # highway TTC view of vi_prior.json) index no table, so the root
            # state's distribution, refreshed each plan, is applied at every
            # node, as in the JAX package.
            self._prior_fn = tabular_prior if self._index_obs else root_prior
            self._tabular_prior = True

    @property
    def _prior_params(self):
        if self._tabular_prior:
            return self._root_prior
        return self.prior_agent.train_state.params

    @staticmethod
    def _boltzmann_rows(q, temperature):
        """Row-wise Boltzmann on the host; a row holding a non-finite Q falls
        back to uniform."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        z = q / max(temperature, 1e-6)
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        probs = e / e.sum(axis=1, keepdims=True)
        ok = np.all(np.isfinite(q), axis=1, keepdims=True)
        return np.where(ok, probs, 1.0 / q.shape[1]).astype(np.float32)

    def _refresh_root_prior(self, observation):
        """The tabular prior of this plan. Its rows are cut to the planner's
        actions and not renormalized, as in the JAX package."""
        pa = self.prior_agent
        root_action = pa.act(observation)  # re-derives tabular views at the root
        A = self.num_actions
        if getattr(self, "_index_obs", False) and hasattr(pa, "state_action_value"):
            table = self._boltzmann_rows(pa.state_action_value, self._temperature)
            self._root_prior = torch.as_tensor(table[:, :A], device=self.device)
            return
        if hasattr(pa, "state_action_value") and hasattr(pa, "mdp") \
                and hasattr(pa.mdp, "state"):
            q = np.asarray(pa.state_action_value[int(pa.mdp.state)], np.float32)
            probs = self._boltzmann_rows(q, self._temperature)[0]
        else:
            probs = np.full((A,), 0.1 / max(A - 1, 1), np.float32)
            probs[int(root_action)] = 0.9
        self._root_prior = torch.as_tensor(probs[:A], device=self.device)

    def planner_plan(self, env, observation):
        functional = env.functional
        if self._tabular_prior:
            self.num_actions = functional.action_space.n
            self._refresh_root_prior(observation)
        obs0 = env.obs if env.obs is not None else torch.as_tensor(np.asarray(observation))[None]
        actions, lengths, tree = mcts_prior_plan(
            functional, env.params, env.state, obs0, self.generator, self._prior_params,
            self._prior_fn, num_actions=functional.action_space.n,
            episodes=int(self.config["episodes"]), horizon=int(self.config["horizon"]),
            gamma=float(self.config["gamma"]), temperature=float(self.config["temperature"]),
            device=self.device)
        self.last_plan_data = tree
        return self.get_plan_list(actions[0], lengths[0])

    def record(self, state, action, reward, next_state, done, info):
        pass

    def save(self, filename):
        return self.prior_agent.save(filename)

    def load(self, filename):
        return self.prior_agent.load(filename)
