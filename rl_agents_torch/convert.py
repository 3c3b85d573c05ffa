"""Carry state between the JAX package and this one.

For a planner the "weights" are the env params, the env states and the tree
arenas. ``from_numpy`` turns the JAX package's NamedTuples (taken as numpy
arrays, e.g. ``CartPoleParams/State``, ``MDPParams/State``, or a garnet's
``MDPParams``) into this package's tensors; ``tree_from_numpy`` does the same
for a tree arena (``OLOPTree``, ``MCTSTree``, ``GapETree``), whose fields are
``[N, ...]`` for one JAX tree and ``[B, N, ...]`` under ``vmap``, and gives the
single tree its leading batch axis; ``graph_from_numpy`` and
``opd_tree_from_numpy`` do it for the arenas that nest an env-state NamedTuple
and a hash table (``Graph``, ``StochasticGraph``, ``OPDTree``,
``StateAwareTree``; ``robust_tree_from_numpy`` for ``RobustTree``), so that a
tree grown by the JAX package can be continued, re-rooted or backed up here;
``highway_state_from_numpy`` takes a highway env state; ``tree_to_numpy`` goes
the other way for comparisons. For a model the weights are the flax
parameter tree: ``flax_params_to_torch`` loads one into a port model of the
zoo, ``torch_params_to_flax`` gives a port model's parameters in its layout.
Tests and ``chip_smoke.py`` use this module; the planning path does not.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device


def _to_tensor(value, device) -> torch.Tensor:
    array = np.array(value)  # a copy: JAX hands out read-only buffers
    if array.dtype.kind == "f":
        array = array.astype(np.float32)
    elif array.dtype.kind in "iu":
        array = array.astype(np.int64)  # index tensors are int64 in the port
    return torch.as_tensor(array, device=device)


def from_numpy(namedtuple_cls, arrays, device="cuda"):
    """Build ``namedtuple_cls`` from a NamedTuple or mapping of array-likes,
    field by field: floats as float32, integers as int64, bools as bool."""
    device = resolve_device(device)
    values = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    return namedtuple_cls(**{name: _to_tensor(values[name], device)
                             for name in namedtuple_cls._fields})


def tree_from_numpy(namedtuple_cls, arrays, device="cuda", batched: bool = True):
    """A tree arena of the JAX package as this package's batch-first arena.
    ``batched=False`` says that ``arrays`` hold one tree, without a batch
    axis: every field then gets a leading axis of 1."""
    tree = from_numpy(namedtuple_cls, arrays, device=device)
    if batched:
        return tree
    return namedtuple_cls(*(t.unsqueeze(0) for t in tree))


def graph_from_numpy(namedtuple_cls, arrays, state_cls, device="cuda", batched: bool = True):
    """A graph or tree arena of the JAX package whose ``states`` field is an
    env-state NamedTuple (``state_cls`` names the port's) and whose ``table``
    field, where it has one, is a hash table. ``batched=False`` as in
    ``tree_from_numpy``."""
    from rl_agents_torch.ops.hashing import HashTable

    device = resolve_device(device)
    nested = {"states": state_cls, "table": HashTable}
    values = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)

    def leaf(value):
        tensor = _to_tensor(value, device)
        return tensor if batched else tensor.unsqueeze(0)

    def field(name):
        if name in nested:
            inner = values[name]
            inner = inner._asdict() if hasattr(inner, "_asdict") else dict(inner)
            return nested[name](**{k: leaf(inner[k]) for k in nested[name]._fields})
        return leaf(values[name])

    return namedtuple_cls(**{name: field(name) for name in namedtuple_cls._fields})


def opd_tree_from_numpy(namedtuple_cls, arrays, state_cls, device="cuda", batched: bool = True):
    """``graph_from_numpy`` under the name of the tree planners' arenas
    (``OPDTree``, ``StateAwareTree``)."""
    return graph_from_numpy(namedtuple_cls, arrays, state_cls, device=device, batched=batched)


def tree_to_numpy(tree):
    """NamedTuple of tensors -> the same NamedTuple of numpy arrays, integer
    fields as int32 (the JAX package's arena dtype) and 32-bit hash keys
    (fields named ``*keys``) as uint32. A field that is itself a NamedTuple
    (env states, a hash table) is converted likewise."""
    def convert(name, t):
        if isinstance(t, tuple):
            return tree_to_numpy(t)
        array = t.detach().cpu().numpy()
        if array.dtype.kind in "iu":
            return array.astype(np.uint32 if name.endswith("keys") else np.int32)
        return array

    return type(tree)(*(convert(name, t) for name, t in zip(tree._fields, tree)))


def highway_state_from_numpy(arrays, device="cuda", batched: bool = True):
    """A ``HighwayState`` of the JAX package (``[V]`` fields for one
    simulation, ``[B, V]`` under ``vmap``) as this package's batch-first
    state; ``batched=False`` adds the batch axis of one."""
    from rl_agents_torch.envs.highway import HighwayState

    return tree_from_numpy(HighwayState, arrays, device=device, batched=batched)


def robust_tree_from_numpy(arrays, state_cls, device="cuda", batched: bool = True):
    """A ``RobustTree`` of the JAX package (node fields ``[N]`` and ``[N, M]``,
    env states ``[N, M, ...]``; one more leading axis under ``vmap``) as this
    package's arena, with the port's ``state_cls`` for its env states."""
    from rl_agents_torch.agents.robust.robust import RobustTree

    return graph_from_numpy(RobustTree, arrays, state_cls, device=device, batched=batched)


def _flax_leaf(tensor: torch.Tensor) -> np.ndarray:
    """A port parameter in flax's layout: a ``Linear`` weight ``[out, in]``
    becomes the ``Dense`` kernel ``[in, out]``, a conv weight ``OIHW`` the
    ``Conv`` kernel ``HWIO``."""
    array = tensor.detach().cpu().float().numpy()
    if array.ndim == 2:
        return array.T
    if array.ndim == 4:
        return array.transpose(2, 3, 1, 0)
    return array


def torch_params_to_flax(model: torch.nn.Module) -> dict:
    """The port model's parameters as the JAX package's parameter tree:
    ``{"params": {submodule: {..., "kernel"|"bias": array}}}``, with the
    names flax gives them."""
    tree: dict = {}
    for name, tensor in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node["kernel" if leaf == "weight" else leaf] = _flax_leaf(tensor)
    return {"params": tree}


def flax_params_to_torch(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load the JAX package's parameter tree (nested mappings of arrays, with
    or without the top ``"params"`` key) into ``model`` in place: a ``Dense``
    kernel ``[in, out]`` is transposed to the ``Linear`` weight, a ``Conv``
    kernel ``HWIO`` becomes ``OIHW``. Every parameter of the model must be
    found, with its shape; returns the model."""
    tree = params.get("params", params) if hasattr(params, "get") else params
    with torch.no_grad():
        for name, tensor in model.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node[part]
            array = np.asarray(node["kernel" if leaf == "weight" else leaf], dtype=np.float32)
            if array.ndim == 2:
                array = array.T
            elif array.ndim == 4:
                array = array.transpose(3, 2, 0, 1)
            if tuple(array.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: flax shape {array.shape} does not fit {tuple(tensor.shape)}")
            tensor.copy_(torch.as_tensor(np.array(array), device=tensor.device))
    return model
