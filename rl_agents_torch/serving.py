"""Ahead-of-time policy export for deployment and serving.

Port of ``rl_agents_tpu/serving.py``. The reference's only deployment
artifact is a pickled torch module inside a ``.tar`` (reference:
deep_q_network/pytorch.py:82-93), which needs the whole framework and its
class definitions at load time. Here the trained greedy policy, its
parameters baked in, is a ``torch.export`` program with a symbolic batch
dimension, saved as one ``.pt2`` file that any process loads with ``torch``
alone and calls at any batch size, on the device it was exported on.
"""
from __future__ import annotations

import copy
from pathlib import Path

import torch
import torch.utils._pytree as pytree


class _GreedyPolicy(torch.nn.Module):
    """``obs -> (argmax action, Q)`` of a Q-network."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, obs):
        q = self.model(obs)
        return q.argmax(dim=-1), q


def export_q_policy(agent) -> torch.export.ExportedProgram:
    """Export a value-based agent's greedy policy as a
    ``torch.export.ExportedProgram``: ``obs [batch, *obs_shape] -> (action
    [batch], q_values [batch, A])`` with ``batch`` a ``torch.export.Dim``.
    Works for any agent with ``model`` and ``train_state.params`` (the DQN
    family); the parameters are copied into the program."""
    model = copy.deepcopy(agent.model).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(agent.train_state.params[name])
    obs_shape = tuple(agent.env.observation_space.shape or (1,))
    example = torch.zeros((2,) + obs_shape, device=agent.device)
    batch = torch.export.Dim("batch", min=1)
    return torch.export.export(_GreedyPolicy(model), (example,),
                               dynamic_shapes={"obs": {0: batch}})


def save_policy(agent, path) -> Path:
    """Export the agent's greedy policy to ``path`` (one ``torch.export`` file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(export_q_policy(agent), path)
    return path


def load_policy(path):
    """Load a policy file into a callable ``obs -> (action, q_values)`` that
    needs no agent, model or env: ``obs`` (anything ``torch.as_tensor``
    takes) goes to the device the policy was exported on as float32."""
    exported = torch.export.load(Path(path))
    module = exported.module()
    device = next(iter(exported.state_dict.values())).device

    @torch.no_grad()
    def policy(obs):
        return module(torch.as_tensor(obs, dtype=torch.float32, device=device))

    policy.exported = exported
    return policy


def register_pytree_serialization(*trees):
    """Register every NamedTuple type in the given nests for
    ``torch.export`` serialization, under its qualified class path. Needed
    to save a program whose inputs or outputs are framework NamedTuples, e.g.
    a planner over env-state batches. Registering a type again under the
    same name does nothing; a type registered earlier under another name
    raises ``ValueError`` (an export with it would deserialize wrongly)."""
    seen = set()

    def walk(obj):
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            cls = type(obj)
            if cls not in seen:
                seen.add(cls)
                _register(cls)
            for value in obj:
                walk(value)
        elif isinstance(obj, (list, tuple)):
            for value in obj:
                walk(value)
        elif isinstance(obj, dict):
            for value in obj.values():
                walk(value)

    for tree in trees:
        walk(tree)


def _register(cls):
    name = f"{cls.__module__}.{cls.__qualname__}"
    existing = pytree.SUPPORTED_SERIALIZED_TYPES.get(cls)
    if existing is not None:
        if existing.serialized_type_name != name:
            raise ValueError(f"{cls.__qualname__} is registered for serialization as "
                             f"{existing.serialized_type_name!r}, not {name!r}")
        return
    pytree._register_namedtuple(cls, serialized_type_name=name)
