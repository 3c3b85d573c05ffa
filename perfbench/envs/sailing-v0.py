"""The sailing domain in the benchmark (env id ``sailing-v0``): its grid
from a configuration's ``env``, the draws of the boats' start states from
the seed, and its plain reference (``reference/sailing.py``).

An env adapter gives the loops and the planner adapters all they know of an
env: ``model``, ``scene_draws``, ``reset``, ``transition`` and
``reference_states``, and here the observations' numbering and keys that
the planner's reference merges nodes by. A scene is a boat's position and
wind; the program's env takes the same draws through its reset's
``noise``.
"""
from __future__ import annotations

import torch

from perfbench.reference import sailing as reference


def model(env_config: dict) -> reference.Model:
    return reference.model_of(env_config)


def scene_draws(gen: torch.Generator, scenes: int, model: reference.Model) -> tuple:
    """``random_start``: positions ``[scenes, 2]`` uniform over the grid
    short of its last row and column (``[0, S - 1)``), then winds
    ``[scenes]`` uniform over the 8 directions."""
    pos = torch.randint(0, model.size - 1, (scenes, 2), generator=gen, device=gen.device)
    wind = torch.randint(0, reference.WINDS, (scenes,), generator=gen, device=gen.device)
    return pos, wind


def reset(model: reference.Model, drawn: tuple, dtype=torch.float32) -> reference.State:
    return reference.reset(model, drawn)


transition = reference.step  # (model, state, action, uniform, dtype) -> (state, reward)
observation = reference.observation
observation_keys = reference.observation_keys


def reference_states(fields) -> reference.State:
    """The program's env state ``(pos, wind, t)`` as the reference's state."""
    pos, wind, _ = fields
    return reference.State(pos, wind)
