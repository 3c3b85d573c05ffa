"""Finite MDP environment with deterministic / stochastic / sparse transition
modes, batch-first.

Port of ``rl_agents_tpu/envs/finite_mdp.py``. The three transition encodings
share one params NamedTuple; the mode is static structure:

* ``deterministic``: transition[S, A] -> next-state index
* ``stochastic``:    transition[S, A, S] -> probability
* ``sparse``:        next[S, A, K] indices + transition[S, A, K] probabilities

Stochastic modes draw the next state as the JAX package does, as
``argmax(log(max(p, 1e-30)) + g)`` with Gumbel noise ``g [B, K]``: injected by
the caller (``noise=``), so that a test can replay the JAX package's own
draws, or drawn from the caller's generator. ``garnet`` draws its random MDP
from a seeded ``torch.Generator``: for one seed it is another MDP than the JAX
package's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.envs.base import Discrete, EnvHandle, EnvSpec, FunctionalEnv, StepOut
from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.noise import NULL_KEY, gumbel, noise_tensor, threefry_gumbel


class MDPParams(NamedTuple):
    transition: Any   # [S,A] i64 / [S,A,S] f32 / [S,A,K] f32
    reward: Any       # [S,A] f32
    terminal: Any     # [S] bool
    next: Any         # [S,A,K] i64 (sparse mode only; else scalar 0)
    initial_state: Any  # [] i64


class MDPState(NamedTuple):
    s: Any     # [B] i64 current state index
    t: Any     # [B] i64 step counter
    done: Any  # [B] bool


class FiniteMDPEnv(FunctionalEnv):
    def __init__(self, num_states: int, num_actions: int, mode: str = "deterministic",
                 max_episode_steps: int = 100):
        if mode not in ("deterministic", "stochastic", "sparse"):
            raise ValueError(f"Unknown mode {mode}")
        self.num_states = num_states
        self.num_actions = num_actions
        self.mode = mode
        self.max_episode_steps = max_episode_steps
        self.spec = EnvSpec("finite-mdp", max_episode_steps)

    @property
    def action_space(self):
        return Discrete(self.num_actions)

    @property
    def observation_space(self):
        return Discrete(self.num_states)

    def default_params(self, device="cuda") -> MDPParams:
        S, A = self.num_states, self.num_actions
        if self.mode == "deterministic":
            transition = torch.zeros((S, A), dtype=torch.int64, device=device)
        else:
            transition = torch.full((S, A, S), 1.0 / S, dtype=torch.float32, device=device)
        return MDPParams(
            transition=transition,
            reward=torch.zeros((S, A), dtype=torch.float32, device=device),
            terminal=torch.zeros((S,), dtype=torch.bool, device=device),
            next=torch.zeros((), dtype=torch.int64, device=device),
            initial_state=torch.zeros((), dtype=torch.int64, device=device),
        )

    def reset_noise(self, params: MDPParams, generator, batch: int = 1):
        """The reset's input, ``[batch]`` int64 start states: every one at
        ``initial_state``, as ``reset`` puts them without ``noise`` (a finite
        MDP's reset draws nothing). A caller that plans from other states
        hands them to ``reset`` as ``noise`` instead."""
        return params.initial_state.expand(batch).clone()

    def reset(self, params: MDPParams, generator, batch: int = 1, noise=None):
        """``batch`` states at their start: ``noise``, ``[batch]`` int64 state
        indices, where it is given, else ``initial_state``."""
        device = params.reward.device
        s = self.reset_noise(params, generator, batch) if noise is None \
            else torch.as_tensor(noise, dtype=torch.int64, device=device).reshape(batch).clone()
        state = MDPState(s=s, t=torch.zeros(batch, dtype=torch.int64, device=device),
                         done=torch.zeros(batch, dtype=torch.bool, device=device))
        return state, state.s

    def observe(self, params, state: MDPState):
        return state.s

    def next_state(self, params: MDPParams, s, action, generator, noise=None):
        """Next states ``[B]``. A wider injected draw than the number of
        outcomes is cut to its first columns (the JAX package's draws for
        fewer outcomes are such a prefix)."""
        rows = _rows(params, s)
        if self.mode == "deterministic":
            return params.transition[rows + (s, action)]
        probs = params.transition[rows + (s, action)]
        K = probs.shape[-1]
        if K == 1:  # one outcome: nothing to draw
            k = torch.zeros_like(s)
        else:
            noise = gumbel(probs.shape, generator, probs.device) if noise is None \
                else noise_tensor(noise, probs.device)
            if noise.shape[-1] < K:
                raise ValueError(f"noise for {noise.shape[-1]} outcomes, the MDP has {K}")
            k = (torch.log(torch.clamp(probs, min=1e-30)) + noise[..., :K]).argmax(dim=-1)
        if self.mode == "stochastic":
            return k
        return params.next[rows + (s, action, k)]

    def null_noise(self, batch: int, device):
        """The Gumbel draw of the JAX package's all-zero key in the stochastic
        modes, for as many outcomes as there are states (``next_state`` cuts
        it to the MDP's outcomes): its deterministic planners step the env
        with that key, so ``jax.random.categorical`` takes one fixed draw per
        number of outcomes. Equal to JAX's within float32 rounding of its
        ``log``."""
        if self.mode == "deterministic":
            return None
        draw = torch.tensor(threefry_gumbel(NULL_KEY, self.num_states), device=device)
        return draw.expand(batch, -1)

    def step(self, params: MDPParams, state: MDPState, action, generator=None,
             noise=None) -> StepOut:
        rows = _rows(params, state.s)
        reward = torch.where(state.done, 0.0, params.reward[rows + (state.s, action)])
        s_next = torch.where(state.done, state.s,
                             self.next_state(params, state.s, action, generator, noise))
        t = state.t + 1
        terminated = params.terminal[rows + (s_next,)] | state.done
        truncated = t >= self.max_episode_steps
        new_state = MDPState(s=s_next, t=t, done=terminated)
        return StepOut(new_state, s_next, reward, terminated, truncated, {})

    def transition(self, params: MDPParams, state: MDPState, action, generator=None,
                   noise=None) -> StepOut:
        """``step``, except that where neither ``generator`` nor ``noise`` is
        given a stochastic MDP takes ``null_noise``, the one fixed draw
        (``step`` raises there)."""
        if generator is None and noise is None:
            noise = self.null_noise(state.s.shape[0], params.reward.device)
        return self.step(params, state, action, generator, noise)


def _rows(params: MDPParams, s):
    """``(rows,)`` when the params carry one MDP per row (a leading batch axis
    on every table, as a robust planner's model ensemble has), else ``()``."""
    if params.reward.dim() == 3:
        return (torch.arange(s.shape[0], device=s.device),)
    return ()


def params_from_config(config: dict, device="cuda",
                       dtype=torch.float32) -> tuple[FiniteMDPEnv, MDPParams]:
    """The env and its params from an inline config. ``dtype`` is the float
    type of the rewards and transition probabilities: float32 as the JAX
    package keeps them, or float64 for a model whose rewards are the
    config's Python floats."""
    device = resolve_device(device)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    mode = config.get("mode", "deterministic")
    transition = np.asarray(config["transition"])
    reward = np.asarray(config["reward"], dtype=np_dtype)
    S, A = reward.shape
    # clamp to S states: the reference corpus's env_bandit.json declares one
    # state but a per-action-length terminal list
    terminal_cfg = np.asarray(config.get("terminal", np.zeros(S)), dtype=bool).reshape(-1)
    terminal = np.zeros(S, bool)
    terminal[:min(S, terminal_cfg.shape[0])] = terminal_cfg[:S]
    # the reference corpus spells the horizon "max_steps"
    max_steps = config.get("max_episode_steps", config.get("max_steps", 100))
    env = FiniteMDPEnv(S, A, mode=mode, max_episode_steps=max_steps)
    if mode == "deterministic":
        transition = transition.astype(np.int64)
        nxt = np.zeros((), np.int64)
    elif mode == "stochastic":
        transition = transition.astype(np_dtype)
        nxt = np.zeros((), np.int64)
    else:
        transition = transition.astype(np_dtype)
        nxt = np.asarray(config["next"], dtype=np.int64)
    params = MDPParams(
        transition=torch.as_tensor(transition, device=device),
        reward=torch.as_tensor(reward, device=device),
        terminal=torch.as_tensor(terminal, device=device),
        next=torch.as_tensor(nxt, device=device),
        initial_state=torch.tensor(int(config.get("initial_state", 0)), dtype=torch.int64,
                                   device=device),
    )
    return env, params


def garnet(generator: torch.Generator, num_states: int, num_actions: int, branching: int = 2,
           reward_sparsity: float = 0.5,
           max_episode_steps: int = 100) -> tuple[FiniteMDPEnv, MDPParams]:
    """Random Garnet MDP (sparse mode), drawn from ``generator`` on its device:
    ``branching`` uniform next states per (state, action) with Dirichlet(1)
    probabilities, and uniform rewards of which the share ``reward_sparsity``
    is set to 0."""
    device = generator.device
    shape = (num_states, num_actions, branching)
    nxt = torch.randint(0, num_states, shape, generator=generator, device=device)
    # Dirichlet(1, ..., 1): normalised unit exponentials
    spacings = -torch.log1p(-torch.rand(shape, generator=generator, device=device))
    probs = spacings / spacings.sum(dim=-1, keepdim=True)
    reward = torch.rand(shape[:2], generator=generator, device=device)
    reward = reward * (reward < (1 - reward_sparsity))
    env = FiniteMDPEnv(num_states, num_actions, mode="sparse",
                       max_episode_steps=max_episode_steps)
    params = MDPParams(
        transition=probs, reward=reward,
        terminal=torch.zeros((num_states,), dtype=torch.bool, device=device), next=nxt,
        initial_state=torch.zeros((), dtype=torch.int64, device=device))
    return env, params


class MDPAccessor:
    """Duck-typed ``env.mdp`` view for the Value Iteration agents
    (reference: value_iteration.py:14 reads env.mdp.{transition,reward,terminal,mode})."""

    def __init__(self, env: FiniteMDPEnv, params: MDPParams):
        self.mode = env.mode
        self.env = env
        self.params = params

    def __getattr__(self, name):
        # numpy copies of the tables, made when first read: ``make`` builds
        # this view for every env and most agents never look at it
        if name in ("transition", "reward", "terminal", "next"):
            value = getattr(self.params, name).cpu().numpy()
            setattr(self, name, value)
            return value
        raise AttributeError(name)

    def next_state(self, s, a, generator: torch.Generator | None = None) -> int:
        if self.mode == "deterministic":
            return int(self.transition[s, a])
        device = self.params.reward.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        index = torch.tensor([s, a], device=device)
        return int(self.env.next_state(self.params, index[:1], index[1:], generator))


def make(config: dict | None = None, device="cuda", dtype=torch.float32) -> EnvHandle:
    """A finite-MDP handle: the inline config's MDP (its rewards in ``dtype``),
    a garnet, or the default loop MDP."""
    config = dict(config or {})
    if "transition" in config:
        env, params = params_from_config(config, device="cpu", dtype=dtype)
    elif config.get("generator") == "garnet":
        # drawn on the CPU, so that one seed gives one MDP on every device; the
        # episode length is the config's (the JAX package's garnet keeps 100)
        env, params = garnet(torch.Generator().manual_seed(config.get("seed", 0)),
                             config.get("num_states", 16), config.get("num_actions", 4),
                             config.get("branching", 2),
                             max_episode_steps=config.get("max_episode_steps",
                                                          config.get("max_steps", 100)))
    else:
        # default small loop MDP (reference scripts/configs/FiniteMDPEnv/env_loop.json shape)
        env, params = params_from_config({
            "mode": "deterministic",
            "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
            "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
            "terminal": [0, 0, 0, 0],
        }, device="cpu")
    handle = EnvHandle(env, params, config, device=device)
    handle.mdp = MDPAccessor(env, handle.params)
    return handle
