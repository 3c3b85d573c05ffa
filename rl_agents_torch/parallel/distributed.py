"""Multi-process bootstrap and host-major device meshes on ``torch.distributed``.

Port of ``rl_agents_tpu/parallel/distributed.py``. The reference scales out
by respawning agents in worker processes with model files as the parameter
channel (reference: trainer/evaluation.py:196-290); here every process runs
the same program over one ``DeviceMesh`` of ranks, one rank per card. The
mesh's outer axis walks hosts (the network between them) and its inner axes
a host's local ranks (NVLink); gradient and statistic reductions are
collectives over the data axes.

* :func:`maybe_initialize_distributed`: call once at program start. It
  initializes the default process group when the arguments or torchrun's
  variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
  announce a run of several processes, NCCL on a card and gloo on the CPU,
  and does nothing in a plain single process.
* :func:`make_pod_mesh`: the ``(host, *local)`` mesh over the group's ranks,
  host-major (torchrun numbers a host's ranks contiguously).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None) -> bool:
    """Initialize the default process group iff this is one process of many.

    Reads (arguments override the environment):

    - ``coordinator_address``: ``host:port`` of rank 0 (or a full
      ``tcp://`` / ``file://`` init method), else ``MASTER_ADDR:MASTER_PORT``;
    - ``num_processes``, else ``WORLD_SIZE``;
    - ``process_id``, else ``RANK``.

    The backend is NCCL when a card is present, each process on card
    ``LOCAL_RANK`` (else ``process_id`` modulo the cards), and gloo on the
    CPU. Returns ``True`` if a group is (now or already) initialized,
    ``False`` for a plain single-process run. Idempotent."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a run of several processes needs this process's rank "
                         "(process_id or RANK)")
    init_method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kwargs = {}
    if torch.cuda.is_available():
        backend = "nccl"
        local = os.environ.get("LOCAL_RANK")
        card = int(local) if local is not None else process_id % torch.cuda.device_count()
        kwargs["device_id"] = torch.device("cuda", card)
        torch.cuda.set_device(card)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kwargs)
    return True


def mesh_device_type() -> str:
    """``"cuda"`` for a NCCL group, else ``"cpu"``."""
    return "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"


def make_pod_mesh(axes: Sequence[str] = ("host", "dp"),
                  hosts: Optional[int] = None,
                  local_shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A host-major mesh over the default group's ranks: ``axes[0]`` is the
    host axis, ``axes[1:]`` partition each host's local ranks.

    ``hosts`` defaults to ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (torchrun's
    variables; one host without them); passing it emulates a topology in one
    host. ``local_shape`` gives the per-host shape of ``axes[1:]`` (default:
    all local ranks on ``axes[1]``, trailing axes of size 1). Raises
    ``ValueError`` when the hosts do not divide the ranks or ``local_shape``
    does not hold a host's ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs an initialized process group "
                           "(maybe_initialize_distributed, or init_process_group)")
    world = dist.get_world_size()
    if hosts is None:
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shape = pod_shape(world, len(axes), hosts, local_shape)
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=tuple(axes))


def pod_shape(world: int, n_axes: int, hosts: int,
              local_shape: Optional[Sequence[int]] = None) -> tuple:
    """The mesh shape ``(hosts, *local_shape)`` for ``world`` ranks, with
    JAX's errors."""
    if hosts < 1 or world % hosts:
        raise ValueError(f"{world} ranks do not divide into {hosts} hosts")
    local = world // hosts
    n_local_axes = n_axes - 1
    if local_shape is None:
        local_shape = (local,) + (1,) * (n_local_axes - 1) if n_local_axes else ()
    if int(np.prod(local_shape or (1,))) != local or len(local_shape) != n_local_axes:
        raise ValueError(f"local_shape {tuple(local_shape)} != {local} ranks/host "
                         f"over {n_local_axes} local axes")
    return (hosts,) + tuple(local_shape)


def data_axes(mesh: DeviceMesh, model_axes: Sequence[str] = ("tp",)) -> tuple:
    """The mesh axes a data batch shards over: every axis that is not a
    model-parallel axis (``('host', 'dp')`` on a ``(host, dp, tp)`` mesh)."""
    return tuple(a for a in mesh.mesh_dim_names if a not in tuple(model_axes))


def data_layout(mesh: Optional[DeviceMesh], axes: Optional[Sequence[str]] = None):
    """``(group, count, index)``: the process group over ``axes`` (default
    ``data_axes(mesh)``) that holds this rank, the number of its ranks, and
    this rank's position in it (host-major). ``(None, 1, 0)`` with no mesh.

    The groups of a multi-axis slice are created collectively, by every rank
    in the same order, on the first call for a mesh and axes under the
    current default group; later calls reuse them (a new group's first
    collective sets up its communicator, which costs far more than a plan)."""
    if mesh is None:
        return None, 1, 0
    axes = tuple(axes) if axes is not None else data_axes(mesh)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        return group, dist.get_world_size(group), dist.get_rank(group)
    return _multi_axis_layout(mesh, axes, dist.group.WORLD)


@functools.lru_cache(maxsize=16)
def _multi_axis_layout(mesh: DeviceMesh, axes: tuple, world):
    """``data_layout`` over several axes; ``world`` (the default group) keys
    the cache, so a group made again after ``destroy_process_group`` starts
    afresh."""
    names = mesh.mesh_dim_names
    data = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in data]
    grid = mesh.mesh.permute(*rest, *data).reshape(-1, int(np.prod([mesh.mesh.shape[i]
                                                                    for i in data])))
    rank = dist.get_rank()
    mine = None
    for ranks in grid.tolist():
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = (group, len(ranks), ranks.index(rank))
    return mine
