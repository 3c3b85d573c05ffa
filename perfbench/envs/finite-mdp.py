"""The finite MDPs in the benchmark (env id ``finite-mdp``): the garnet's
tables from a configuration's ``env``, the draws of the trees' start states
from the seed, and its plain reference (``reference/garnet.py``).

An env adapter gives the loops and the planner adapters all they know of an
env: ``model``, ``scene_draws``, ``reset``, ``transition`` and
``reference_states``. A scene is a start state; the program's env takes the
same draws through its reset's ``noise``.
"""
from __future__ import annotations

import torch

from perfbench.reference import garnet as reference


def model(env_config: dict) -> reference.Model:
    return reference.model_of(env_config)


def scene_draws(gen: torch.Generator, scenes: int, model: reference.Model) -> torch.Tensor:
    """``[scenes]`` start states, uniform over the MDP's states."""
    return torch.randint(0, model.num_states, (scenes,), generator=gen, device=gen.device)


def reset(model: reference.Model, drawn: torch.Tensor, dtype=torch.float32) -> reference.State:
    return reference.reset(model, drawn)


transition = reference.step  # (model, state, action, gumbel, dtype) -> (state, reward, terminated)


def reference_states(fields) -> reference.State:
    """The program's env state ``(s, t, done)`` as the reference's state."""
    s, _, done = fields
    return reference.State(s, done)
