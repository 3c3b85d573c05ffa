"""Plain reference of the Garnet MDP (Archibald, McKinnon and Thomas, "On the
generation of Markov decision processes", 1995), as eleurent/finite-mdp
draws it: each (state, action) leads to ``branching`` next states drawn
uniformly, with Dirichlet(1, ..., 1) probabilities, and has a reward
uniform in [0, 1), of which the share ``reward_sparsity`` is set to 0.

The tables are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
in this order: the next states (``randint``), the Dirichlet draws as unit
exponentials ``-log(1 - u)`` normalised over the branches, then the
rewards. The same seed in numpy draws another MDP.

A step from state ``s`` under action ``a`` takes the branch
``argmax_k log(max(p_k, 1e-30)) + g_k`` for given Gumbel draws ``g`` (a
categorical draw), and earns ``reward[s, a]``; a state already done stays
and earns 0. No garnet state is terminal. Plain PyTorch; imports nothing of
the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Model(NamedTuple):
    next: torch.Tensor      # [S, A, K] int64 next states
    probs: torch.Tensor     # [S, A, K] float32 their probabilities
    reward: torch.Tensor    # [S, A] float32
    terminal: torch.Tensor  # [S] bool

    @property
    def num_states(self) -> int:
        return self.reward.shape[0]

    @property
    def num_actions(self) -> int:
        return self.reward.shape[1]


class State(NamedTuple):
    s: torch.Tensor     # [B] int64
    done: torch.Tensor  # [B] bool


def draw(seed: int, num_states: int, num_actions: int, branching: int,
         reward_sparsity: float = 0.5) -> Model:
    gen = torch.Generator().manual_seed(int(seed))
    shape = (num_states, num_actions, branching)
    nxt = torch.randint(0, num_states, shape, generator=gen)
    exponentials = -torch.log1p(-torch.rand(shape, generator=gen))
    probs = exponentials / exponentials.sum(dim=-1, keepdim=True)
    reward = torch.rand((num_states, num_actions), generator=gen)
    reward = reward * (reward < 1 - reward_sparsity)
    return Model(nxt, probs, reward, torch.zeros(num_states, dtype=torch.bool))


def model_of(env_config: dict) -> Model:
    """The garnet of a corpus env file (``FiniteMDPEnv/env_garnet.json``)."""
    if env_config.get("generator") != "garnet":
        raise ValueError("the plain reference knows the garnet only")
    return draw(env_config.get("seed", 0), env_config.get("num_states", 16),
                env_config.get("num_actions", 4), env_config.get("branching", 2))


def to(model: Model, device) -> Model:
    return Model(*(x.to(device) for x in model))


def reset(model: Model, starts: torch.Tensor) -> State:
    return State(starts.to(torch.int64).clone(), torch.zeros_like(starts, dtype=torch.bool))


def step(model: Model, state: State, action: torch.Tensor, gumbel: torch.Tensor,
         dtype=torch.float32):
    """``(next state, reward, terminated)`` of each row under its Gumbel draws
    ``[B, K]``; the reward in ``dtype``, the branch chosen in ``dtype``."""
    model = to(model, state.s.device)
    probs = model.probs[state.s, action].to(dtype)
    scores = torch.log(torch.clamp(probs, min=1e-30)) + gumbel[..., :probs.shape[-1]].to(dtype)
    branch = scores.argmax(dim=-1)
    landed = model.next[state.s, action, branch]
    s_next = torch.where(state.done, state.s, landed)
    reward = torch.where(state.done, 0.0, model.reward[state.s, action].to(dtype))
    terminated = model.terminal[s_next] | state.done
    return State(s_next, terminated), reward, terminated
