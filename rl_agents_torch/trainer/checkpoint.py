"""Step-indexed checkpoints of nests of tensors.

Port of ``rl_agents_tpu/trainer/checkpoint.py``, whose orbax store becomes a
directory of ``torch.save`` files: ``CheckpointStore`` keeps the last
``max_to_keep`` steps, each written to a temporary directory and moved into
place with ``os.replace``, so a partial write never replaces a good step.
A nest is any mix of dicts, lists, tuples, NamedTuples, tensors (DTensors
too), ``torch.Generator`` (saved through ``get_state()``), numbers, strings
and None: the whole fused train state of ``parallel/actor_learner.py``,
sharded or not, round-trips as one object.

In a run with a ``torch.distributed`` process group every rank calls
``save`` and ``restore``. Rank 0 clears and moves the directories and the
ranks meet at barriers around it, as JAX's ``_barrier``. Each rank writes
the leaves it holds a shard of to ``rank-{r}.pt``: the leaves that
``shardings`` marks ``Shard(...)`` (each rank's own rows of a sharded
learner state) and the local shard of every DTensor. Replicated leaves are
written once, by rank 0, to ``tree.pt``.
"""
from __future__ import annotations

import importlib
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


TREE_FILE = "tree.pt"
RANK_FILE = "rank-{}.pt"


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier():
    """Meet the other ranks; nothing in a single-process run."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _flatten(tree, shardings, shared: dict, local: dict):
    """The nest's structure as plain lists, dicts and strings (loadable with
    ``weights_only=True``); tensors go to ``shared`` (replicated) or
    ``local`` (this rank's shard) under their leaf index."""
    def leaf_index():
        return len(shared) + len(local)

    if isinstance(tree, DTensor):
        index = leaf_index()
        local[index] = tree.to_local().detach().cpu()
        return {"kind": "dtensor", "index": index}
    if isinstance(tree, torch.Tensor):
        index = leaf_index()
        (local if isinstance(shardings, Shard) else shared)[index] = tree.detach().cpu()
        return {"kind": "tensor", "index": index, "device": str(tree.device)}
    if isinstance(tree, torch.Generator):
        index = leaf_index()
        (local if isinstance(shardings, Shard) else shared)[index] = tree.get_state()
        return {"kind": "generator", "index": index, "device": str(tree.device)}
    if isinstance(tree, dict):
        keys = list(tree)
        return {"kind": "dict", "keys": keys,
                "children": [_flatten(tree[k], _sub(shardings, k), shared, local) for k in keys]}
    if _is_namedtuple(tree):
        cls = type(tree)
        return {"kind": "namedtuple", "module": cls.__module__, "name": cls.__qualname__,
                "children": [_flatten(v, _sub(shardings, i), shared, local)
                             for i, v in enumerate(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"kind": type(tree).__name__,
                "children": [_flatten(v, _sub(shardings, i), shared, local)
                             for i, v in enumerate(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"kind": "value", "value": tree}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _sub(shardings, key):
    """The placement of child ``key``: a placement applies to its whole subtree."""
    if isinstance(shardings, (dict, list, tuple)):
        return shardings[key]
    return shardings


def _template_child(template, key):
    if template is None:
        return None
    if isinstance(template, dict):
        return template.get(key)
    return template[key] if key < len(template) else None


def _unflatten(node, leaves: dict, template):
    kind = node["kind"]
    if kind == "dtensor":
        value = leaves[node["index"]]
        if isinstance(template, DTensor):
            value = value.to(device=template.to_local().device, dtype=template.dtype)
            return DTensor.from_local(value, template.device_mesh, template.placements,
                                      shape=template.shape, stride=template.stride())
        return value
    if kind == "tensor":
        value = leaves[node["index"]]
        if isinstance(template, torch.Tensor):
            return value.to(device=template.device, dtype=template.dtype)
        return value
    if kind == "generator":
        generator = template if isinstance(template, torch.Generator) \
            else torch.Generator(device=node["device"])
        generator.set_state(leaves[node["index"]])
        return generator
    if kind == "value":
        return node["value"]
    children = node["children"]
    if kind == "dict":
        return {k: _unflatten(c, leaves, _template_child(template, k))
                for k, c in zip(node["keys"], children)}
    values = [_unflatten(c, leaves, _template_child(template, i)) for i, c in enumerate(children)]
    if kind == "namedtuple":
        cls = type(template) if _is_namedtuple(template) else _import(node["module"], node["name"])
        return cls(*values)
    return values if kind == "list" else tuple(values)


def _import(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _write(directory: Path, tree, shardings):
    """Write ``tree`` into ``directory`` (which every rank sees): rank 0 the
    structure and the replicated leaves, each rank its own shards."""
    rank, world = _rank_world()
    shared, local = {}, {}
    structure = _flatten(tree, shardings, shared, local)
    if rank == 0:
        torch.save({"structure": structure, "leaves": shared, "world_size": world},
                   directory / TREE_FILE)
    if local:
        torch.save({"leaves": local}, directory / RANK_FILE.format(rank))


def _read(directory: Path, template):
    rank, world = _rank_world()
    saved = torch.load(directory / TREE_FILE, map_location="cpu", weights_only=True)
    if saved["world_size"] != world:
        raise ValueError(f"{directory} was written by {saved['world_size']} ranks, "
                         f"restored by {world}")
    leaves = dict(saved["leaves"])
    own = directory / RANK_FILE.format(rank)
    if own.exists():
        leaves.update(torch.load(own, map_location="cpu", weights_only=True)["leaves"])
    return _unflatten(saved["structure"], leaves, template)


def _replace_dir(tmp: Path, final: Path):
    """Move ``tmp`` to ``final``, replacing a directory already there."""
    old = final.with_name(f".old-{final.name}")
    if old.exists():
        shutil.rmtree(old)
    if final.exists():
        os.replace(final, old)
    os.replace(tmp, final)
    if old.exists():
        shutil.rmtree(old)


class CheckpointStore:
    """A step-indexed checkpoint directory with retention.

    ``save(step, tree)`` writes atomically; ``restore(step=None,
    template=None)`` reads the latest (or a given) step. With ``template``,
    a nest like the saved one, each leaf is placed on the template leaf's
    device and dtype (a DTensor on its mesh and placements, a generator's
    state set into the template's generator); without one, tensors come back
    on the CPU and a generator on the device it was saved from."""

    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        if _rank_world()[0] == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
        _barrier()

    def save(self, step: int, tree: Any, shardings: Any = None) -> Path:
        """Write ``tree`` as ``step``; ``shardings`` (a nest like ``tree``, or
        one placement for all of it) marks the leaves that each rank holds
        its own shard of with ``Shard(...)``."""
        step = int(step)
        rank, _ = _rank_world()
        final = self.directory / str(step)
        tmp = self.directory / f".tmp-{step}"
        if rank == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        _barrier()
        _write(tmp, tree, shardings)
        _barrier()
        if rank == 0:
            _replace_dir(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep or None]:
                shutil.rmtree(self.directory / str(old))
        _barrier()
        return final

    def restore(self, step: Optional[int] = None, template: Any = None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return _read(self.directory / str(int(step)), template)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def close(self):
        """Nothing stays open between calls; kept for the JAX store's API."""


def save_pytree(path, tree: Any, shardings: Any = None) -> Path:
    """One-shot atomic checkpoint of ``tree`` at ``path`` (a directory),
    replacing whatever was there."""
    path = Path(path).absolute()
    rank, _ = _rank_world()
    tmp = path.with_name(f".tmp-{path.name}")
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _barrier()
    _write(tmp, tree, shardings)
    _barrier()
    if rank == 0:
        _replace_dir(tmp, path)
    _barrier()
    return path


def load_pytree(path, template: Any = None):
    """Restore a ``save_pytree`` checkpoint (``template`` as in
    ``CheckpointStore.restore``). Raises ``FileNotFoundError`` without
    touching the disk when ``path`` is absent."""
    path = Path(path)
    if not (path / TREE_FILE).exists():
        raise FileNotFoundError(f"No checkpoint directory at {path}")
    return _read(path, template)
