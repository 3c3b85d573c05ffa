"""Cross-Entropy Method planning, batch-first over plans and candidates.

Port of ``rl_agents_tpu/agents/cem.py`` (reference: cross_entropy_method/
cem.py:8-66 and pytorch.py:20-44): a Gaussian belief over action sequences
is refit to the top candidates each iteration. All candidates of all B plans
roll out as one env step over ``[B * candidates]`` states per time step, and
the learned-model variant (``LatentCEMAgent``, PlaNet-style) batches the
candidates through the transition and reward models the same way.

The top candidates are taken by a stable descending sort: ``jax.lax.top_k``
returns the lowest indices among equal returns, and CartPole at
``gamma = 1`` has integer returns, so ties are the common case there;
``torch.topk`` gives no tie order. The refit std is biased (the reference's
``unbiased=False``). A discrete action is the first action coordinate cast
to an integer, truncating toward zero, and the agent's plan is
``mean > 0.5``, so only actions 0 and 1 are ever planned (the JAX package's
behaviour, kept; ``ROADMAP.md`` §3).

The standard normal draws of each iteration (``noise.normal [I, B, C, H, S]``)
and the env's own draws (``noise.env [I, B, C, H, ...]``) may be injected;
otherwise they come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.agents.tree_search.mcts import discount_table
from rl_agents_torch.envs.base import Box, FunctionalEnv, params_to
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import fma
from rl_agents_torch.utils.noise import noise_tensor


class CEMNoise(NamedTuple):
    normal: Any  # [iterations, B, candidates, horizon, action_size]
    env: Any     # [iterations, B, candidates, horizon, ...] or None


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def refit(actions, returns, top_candidates: int):
    """Mean and biased std of the ``top_candidates`` best candidates of each
    plan, the lowest index first among equal returns. ``actions [B, C, H, S]``,
    ``returns [B, C]``."""
    order = torch.sort(returns, dim=1, descending=True, stable=True).indices[:, :top_candidates]
    best = actions.gather(1, order[:, :, None, None].expand((-1, -1) + actions.shape[2:]))
    return best.mean(dim=1), best.std(dim=1, unbiased=False)


def cem_plan(env: FunctionalEnv, params, states0, generator: torch.Generator | None,
             horizon: int, iterations: int, candidates: int, top_candidates: int, gamma: float,
             action_size: int, discrete: bool = False, noise: CEMNoise | None = None,
             device="cuda"):
    """``iterations`` x [sample -> roll out every candidate -> refit] for B
    plans from ``states0``. Returns ``(mean [B, H, S], best_returns [B, I])``."""
    device = resolve_device(device)
    params = params_to(params, device)
    states0 = params_to(states0, device)
    B = states0[0].shape[0]
    C, H, S = candidates, horizon, action_size
    f32 = torch.float32
    discounts = discount_table(gamma, H, device)
    start = type(states0)(*(x.repeat_interleave(C, dim=0) for x in states0))
    mean = torch.zeros((B, H, S), dtype=f32, device=device)
    std = torch.ones((B, H, S), dtype=f32, device=device)
    best_returns = []
    for it in range(iterations):
        if noise is None:
            if generator is None:
                raise ValueError("cem_plan needs a generator or noise")
            eps = _normal((B, C, H, S), generator, device)
        else:
            eps = noise_tensor(noise.normal[it], device)
        # mean + std * eps is one fused multiply-add in the JAX package
        actions = fma(std[:, None], eps, mean[:, None])
        state, live = start, torch.ones(B * C, dtype=torch.bool, device=device)
        returns = torch.zeros(B * C, dtype=f32, device=device)
        for t in range(H):
            action = actions[:, :, t].reshape(B * C, S)
            action = action[:, 0].to(torch.int64) if discrete else action
            env_noise = None
            if noise is not None and noise.env is not None:
                env_noise = noise_tensor(noise.env[it], device)[:, :, t]
                env_noise = env_noise.reshape((B * C,) + env_noise.shape[2:])
            out = env.transition(params, state, action, generator, env_noise)
            reward = torch.where(live, out.reward.to(f32), 0.0)
            returns = returns + reward * discounts[t]
            state = out.state
            live = live & ~(out.terminated | out.truncated)
        returns = returns.reshape(B, C)
        mean, std = refit(actions, returns, top_candidates)
        best_returns.append(returns.amax(dim=1))
    return mean, torch.stack(best_returns, dim=1)


class CEMAgent(AbstractAgent):
    """CEM planner with the environment as its model (reference: cem.py:8-66)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        space = env.action_space
        if isinstance(space, Box):
            self.action_size = int(np.prod(space.shape)) or 1
            self.discrete = False
        else:
            self.action_size = 1
            self.discrete = True
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)

    @classmethod
    def default_config(cls):
        return dict(gamma=1.0, horizon=10, iterations=10, candidates=100, top_candidates=10)

    def plan(self, observation):
        mean, _ = cem_plan(
            self.env.functional, self.env.params, self.env.state, self.generator,
            horizon=self.config["horizon"], iterations=self.config["iterations"],
            candidates=self.config["candidates"], top_candidates=self.config["top_candidates"],
            gamma=self.config["gamma"], action_size=self.action_size, discrete=self.discrete,
            device=self.device)
        return self.plan_from_mean(mean[0])

    def plan_from_mean(self, mean):
        """The plan of a fitted mean ``[H, S]``: ``mean > 0.5`` as actions for a
        discrete action space (the JAX package's rule), the mean itself
        otherwise."""
        if self.discrete:
            return [int(a) for a in (mean[:, 0] > 0.5).cpu().numpy()]
        return mean.cpu().numpy().tolist()

    def act(self, state):
        return self.plan(state)[0]

    def record(self, state, action, reward, next_state, done, info):
        pass

    def reset(self):
        pass

    def seed(self, seed=None):
        if seed is not None:
            self.generator.manual_seed(seed)
        return [seed]


class LatentCEMAgent(CEMAgent):
    """CEM over learned latent models, batched like PlaNet (reference:
    cross_entropy_method/pytorch.py:20-44). ``transition_model(state,
    action, belief) -> (belief, state)`` and ``reward_model(belief, state)
    -> reward`` are tensor callables over a leading candidate axis."""

    def __init__(self, env, config=None, transition_model: Callable = None,
                 reward_model: Callable = None, device="cuda"):
        super().__init__(env, config, device=device)
        self.transition_model = transition_model
        self.reward_model = reward_model

    def plan(self, belief, state, normals=None):
        """The first action of the fitted mean, as a list. ``normals
        [iterations, candidates, horizon, action_size]`` may inject the
        draws."""
        C, H = self.config["candidates"], self.config["horizon"]
        S, K = self.action_size, self.config["top_candidates"]
        f32 = torch.float32
        belief = torch.as_tensor(np.asarray(belief), dtype=f32, device=self.device)
        state = torch.as_tensor(np.asarray(state), dtype=f32, device=self.device)
        belief = belief.expand((C,) + belief.shape[-1:])
        state = state.expand((C,) + state.shape[-1:])
        mean = torch.zeros((1, H, S), dtype=f32, device=self.device)
        std = torch.ones((1, H, S), dtype=f32, device=self.device)
        for it in range(self.config["iterations"]):
            eps = _normal((1, C, H, S), self.generator, self.device) if normals is None \
                else noise_tensor(normals[it], self.device)[None]
            actions = fma(std[:, None], eps, mean[:, None])
            b, s = belief, state
            returns = torch.zeros(C, dtype=f32, device=self.device)
            for t in range(H):
                b, s = self.transition_model(s, actions[0, :, t], b)
                returns = returns + self.reward_model(b, s)
            mean, std = refit(actions, returns[None], K)
        return mean[0, 0].cpu().numpy().tolist()
