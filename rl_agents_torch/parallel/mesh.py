"""Device meshes and the sharded DQN train step and planner batch.

Port of ``rl_agents_tpu/parallel/mesh.py`` on ``torch.distributed``. The
reference's parallelism is process pools and model files on disk (reference:
trainer/evaluation.py:196-290, scripts/experiments.py:105-106); here every
rank runs the same program:

* the data axes (``dp``, or ``host`` and ``dp``): each rank holds its slice
  of the env, replay and minibatch rows, and gradients are all-reduced to
  their mean over the data group;
* the ``tp`` axis: wide layers' weights are sharded over it through
  ``torch.distributed.tensor`` (JAX's ``P(None, "tp")`` on a ``[in, out]``
  kernel is ``Shard(0)`` on a torch ``[out, in]`` weight);
* planner tree batches shard over the data axes, and an ``all_gather``
  returns the whole batch.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.func import functional_call

from rl_agents_torch.agents.dqn.replay import Batch
from rl_agents_torch.models.optimizers import apply_updates
from rl_agents_torch.parallel.distributed import data_layout, mesh_device_type


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp", "tp"),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over the default group's ranks; by default all of them on
    ``axes[0]`` and the other axes of size 1."""
    n = n_devices or dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks")
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_rows(tree, count: int, index: int):
    """Block ``index`` of ``count`` equal blocks of every tensor's leading axis."""
    def take(x):
        if x.shape[0] % count:
            raise ValueError(f"{x.shape[0]} rows do not split over {count} data ranks")
        n = x.shape[0] // count
        return x[index * n:(index + 1) * n]
    return _map(take, tree)


def shard_batch(mesh: Optional[DeviceMesh], batch, axis="dp"):
    """This rank's slice of the leading axis of every tensor of ``batch``
    over the mesh axis ``axis`` (a name, or a tuple of names, e.g.
    ``("host", "dp")`` on a pod mesh)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    _, count, index = data_layout(mesh, axes)
    return shard_rows(batch, count, index)


def mlp_param_spec(params: Dict[str, torch.Tensor], tp_axis: str = "tp",
                   mesh: Optional[DeviceMesh] = None) -> Dict[str, object]:
    """Tensor-parallel placement of each parameter over ``tp``: a 2-D
    ``weight`` ``[out, in]`` and a 1-D ``bias`` shard their output dim
    (``Shard(0)``), everything else is replicated. With ``mesh``, a leaf whose
    output dim does not divide the tp size stays replicated."""
    tp_size = mesh.size(mesh.mesh_dim_names.index(tp_axis)) if mesh is not None else None

    def spec(name, x):
        divides = tp_size is None or x.shape[0] % tp_size == 0
        if x.dim() == 2 and name.endswith("weight") and divides:
            return Shard(0)
        if x.dim() == 1 and name.endswith("bias") and divides:
            return Shard(0)
        return Replicate()
    return {name: spec(name, x) for name, x in params.items()}


class DataParallel:
    """The collectives of one data-parallel (and optionally tensor-parallel)
    learner: parameters as DTensors on the mesh's ``tp`` axis when ``tp``,
    plain replicated tensors otherwise; gradients all-reduced (summed) over
    the data group; a statistic vector summed over it. With no mesh or no
    initialized group it is the one-rank program and runs no collective."""

    def __init__(self, mesh: Optional[DeviceMesh], tp: bool = False):
        self.mesh = mesh
        active = mesh is not None and dist.is_initialized()
        self.group, self.count, self.index = data_layout(mesh) if active else (None, 1, 0)
        self.active = active
        self.tp_mesh = mesh["tp"] if active and tp and "tp" in mesh.mesh_dim_names else None

    # ---- parameters -----------------------------------------------------
    def place(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``params`` made equal on every rank (rank 0's values), and
        sharded over ``tp`` by ``mlp_param_spec`` when tensor-parallel."""
        if self.active:
            for value in params.values():
                dist.broadcast(value, src=0)
        if self.tp_mesh is None:
            return params
        specs = mlp_param_spec(params, mesh=self.mesh)
        return {k: DTensor.from_local(self._local(v, specs[k]), self.tp_mesh, [specs[k]],
                                      run_check=False)
                for k, v in params.items()}

    def _local(self, full: torch.Tensor, placement):
        if isinstance(placement, Shard):
            n = full.shape[0] // self.tp_mesh.size()
            i = self.tp_mesh.get_local_rank()
            return full[i * n:(i + 1) * n].contiguous()
        return full

    def place_like(self, tensors, params: Dict[str, torch.Tensor]):
        """A list of per-parameter tensors (an optimizer moment) as the local
        shards of ``params``' placements."""
        if self.tp_mesh is None:
            return tensors
        return [self._local(t, p.placements[0]) if isinstance(p, DTensor) else t
                for t, p in zip(tensors, params.values())]

    def q_values(self, model, params, x):
        """The model's output on ``x`` as a plain tensor, the same on every
        tp rank."""
        if self.tp_mesh is None or not any(isinstance(v, DTensor) for v in params.values()):
            return functional_call(model, params, (x,))
        xd = DTensor.from_local(x, self.tp_mesh, [Replicate()], run_check=False)
        with implicit_replication():
            return functional_call(model, params, (xd,)).full_tensor()

    # ---- reductions -----------------------------------------------------
    def all_reduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` over the data group in place."""
        if self.active:
            dist.all_reduce(flat, group=self.group)
        return flat

    def reduce_gradients(self, grads):
        """Local gradients summed over the data group (one all-reduce)."""
        if not self.active:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat)
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]

    # ---- the update -----------------------------------------------------
    def gradients(self, loss, params: Dict[str, torch.Tensor]):
        """d loss / d params as local tensors (each DTensor gradient laid out
        as its parameter)."""
        with implicit_replication():
            grads = torch.autograd.grad(loss, list(params.values()))
        return [g.redistribute(p.device_mesh, p.placements).to_local()
                if isinstance(g, DTensor) else g for g, p in zip(grads, params.values())]

    def apply(self, optimizer, params: Dict[str, torch.Tensor], opt_state, grads):
        """One optimizer step on the local shards; returns ``(params,
        opt_state)`` laid out as before."""
        locals_ = [p.to_local() if isinstance(p, DTensor) else p for p in params.values()]
        updates, opt_state = optimizer.update(grads, opt_state, locals_)
        new = apply_updates(locals_, updates)
        out = {}
        for (name, old), value in zip(params.items(), new):
            out[name] = DTensor.from_local(value, old.device_mesh, old.placements,
                                           run_check=False, shape=old.shape,
                                           stride=old.stride()) \
                if isinstance(old, DTensor) else value
        return out, opt_state


def clip_(grads):
    """Clip every gradient elementwise to [-1, 1] in place, after the reduce
    (JAX clips the global gradient)."""
    torch._foreach_clamp_min_(grads, -1.0)
    torch._foreach_clamp_max_(grads, 1.0)
    return grads


def dqn_loss(q_fn, params, target_params, batch: Batch, gamma: float, double: bool,
             rows: int):
    """The sum over this rank's rows of the squared Bellman residual, divided
    by ``rows``, the global minibatch: summed over the data group it is
    JAX's mean over the sharded minibatch."""
    with torch.no_grad():
        q_next = q_fn(target_params, batch.next_state)
        if double:
            best = q_fn(params, batch.next_state).argmax(dim=1)
            best_values = q_next.gather(1, best[:, None]).squeeze(1)
        else:
            best_values = q_next.max(dim=1).values
        target = batch.reward + gamma * torch.where(batch.terminal, 0.0, best_values)
    q_sa = q_fn(params, batch.state).gather(1, batch.action[:, None]).squeeze(1)
    return ((q_sa - target) ** 2).sum() / rows


def make_sharded_train_step(mesh: Optional[DeviceMesh], model, optimizer, gamma: float,
                            double: bool = True, tp: bool = True):
    """The DQN train step over the mesh: the batch over every data axis
    (each rank passes its slice), parameters over ``tp`` (or replicated).
    Returns ``(train_step, place)``: ``place(params, opt_state)`` lays
    parameters and optimizer state out on the mesh, and ``train_step(params,
    target_params, opt_state, batch) -> (params, opt_state, loss)`` takes
    the loss's gradients on this rank's rows, all-reduces them to the mean
    over the data group, clips them to [-1, 1] and steps the optimizer; the
    loss is the global mean."""
    parallel = DataParallel(mesh, tp=tp)

    def place(params, opt_state):
        params = parallel.place(dict(params))
        opt_state = {k: parallel.place_like(v, params) if isinstance(v, list) else v
                     for k, v in opt_state.items()}
        return params, opt_state

    def train_step(params, target_params, opt_state, batch: Batch):
        rows = batch.action.shape[0] * parallel.count
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        q_fn = lambda p, x: parallel.q_values(model, p, x)
        loss = dqn_loss(q_fn, leaves, target_params, batch, gamma, double, rows)
        grads = clip_(parallel.reduce_gradients(parallel.gradients(loss, leaves)))
        params, opt_state = parallel.apply(optimizer, params, opt_state, grads)
        return params, opt_state, parallel.all_reduce_(loss.detach().reshape(1))[0]

    return train_step, place


def sharded_planner_batch(mesh: Optional[DeviceMesh], plan_fn, params, states, noise=None,
                          axes=None, noise_axis: int = 0):
    """Plan a batch of independent trees over the mesh's data axes: each
    rank plans its slice of ``states`` (and of ``noise`` along
    ``noise_axis``) with ``plan_fn(params, states, noise)``, and an
    ``all_gather`` over the data group returns the whole batch on every rank.
    ``plan_fn`` returns a tensor or a tuple of tensors, each with the tree
    axis first. With no mesh it is ``plan_fn`` on the whole batch."""
    active = mesh is not None and dist.is_initialized()
    group, count, index = data_layout(mesh, axes) if active else (None, 1, 0)
    local_states = shard_rows(states, count, index)
    if noise is not None:
        noise = _map(lambda x: shard_rows(x.movedim(noise_axis, 0), count, index)
                     .movedim(0, noise_axis), noise)
    out = plan_fn(params, local_states, noise)
    if not active:
        return out

    def gather(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(count)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)
    if isinstance(out, torch.Tensor):
        return gather(out)
    return type(out)(*(gather(x) for x in out)) if hasattr(out, "_fields") \
        else type(out)(gather(x) for x in out)
