"""The highway env in the benchmark: its parameters from a configuration's
``env``, the draws of its scenes from the seed, and its plain reference.

An env adapter is found by the configuration's env id
(``perfbench/envs/<id>.py``) and gives the loops and the planner adapters
all they know of an env: ``model``, ``scene_draws``, ``reset``,
``transition`` and ``reference_states``. The program's own env takes the
same draws through its reset's ``noise``.
"""
from __future__ import annotations

import torch

from perfbench.reference import highway as reference


def model(env_config: dict) -> reference.Model:
    return reference.model_of(env_config)


def scene_draws(gen: torch.Generator, scenes: int, model: reference.Model) -> tuple:
    """The reset's draws, ``[scenes, vehicles]`` each: spacing uniforms, lane
    indices, speed uniforms."""
    device = gen.device
    shape = (scenes, model.vehicles)
    spacing = torch.rand(shape, generator=gen, device=device)
    lane = torch.randint(0, model.lanes, shape, generator=gen, device=device)
    speed = torch.rand(shape, generator=gen, device=device)
    return spacing, lane, speed


def reset(model: reference.Model, drawn: tuple, dtype=torch.float32) -> reference.Scene:
    return reference.reset(model, *drawn, dtype=dtype)


transition = reference.transition  # (model, scenes, actions, dtype) -> (scenes, reward, crashed)


def reference_states(fields) -> reference.Scene:
    """The fields of the program's env state, in its order, as the
    reference's scene (the same fields in the same order)."""
    return reference.Scene(*fields)
