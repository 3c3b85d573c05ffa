"""Batched KL-UCB/LCB solve: the CUDA kernels of ``csrc/kl_bound.cu`` and
their plain PyTorch versions.

Replaces the Pallas TPU kernel ``rl_agents_tpu/ops/pallas_kl.py::_kl_bound_kernel``
(launched by ``kl_bound_pallas``), which is a drop-in for
``utils/math.py::kl_upper_bound``: with ``iters=NEWTON_MAX_ITERATIONS`` the
per-element freeze reproduces that solver's per-element stop, so the OLOP
planner calls this in its place.

Three launch forms share one device solve:

- ``kl_bound``, dense: broadcastable f32 inputs, a new output. It moves 16
  bytes per element and at large sizes is bound by memory bytes.
- ``kl_bound_indexed_``, OLOP's form: solves the nodes of one OLOP
  episode's path ``nodes [H, B]`` inside a ``[B, N]`` tree arena and writes
  them in place, one launch per episode. At the planner's 8 x 4096 nodes it
  is bound by launch latency and by the longest Newton chain of a warp.
- ``kl_bounds_pair_``, MDP-GapE's and stochastic GBOP's form: solves the
  upper and the lower bound of the entries at flat offsets ``at [..., B]``
  of ``[B, ...]`` arenas and writes both in place, under an optional
  per-tree mask, with a scalar threshold or one indexed by each entry's
  count. One thread steps both Newton chains side by side. Its wrapper does
  no broadcast, cast, copy or allocation: it checks its arguments and makes
  one call.

One thread per element, all trips in registers, and a thread stops once its
element froze (see the note in the CUDA source).

Each wrapper launches its kernel on a CUDA tensor, or raises; on a CPU tensor
it runs its plain version. There is no fallback between the two. The shared
library is built from the repository's source with ``nvcc`` at first use into
``rl_agents_torch/_build/``, keyed on a hash of the source and flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.math import (
    NEWTON_MAX_ITERATIONS,
    _bounded_newton_step,
    bernoulli_kullback_leibler,
    d_bernoulli_kullback_leibler_dq,
)

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "kl_bound.cu"
BUILD_DIR = _PACKAGE / "_build"
# no --use_fast_math: logf, division, inf and nan keep IEEE semantics;
# --fmad=false: no contraction into FMA, each op rounds like the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the kl_bound kernel cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Build the kernel's shared library if it is not built yet; return its
    path. The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside it as ``<library>.log``. A failed build raises with that output."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"kl_bound_{digest}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    lib_path.with_suffix(".so.log").write_text(log)
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.kl_bound_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.kl_bound_launch.restype = ctypes.c_int
        lib.kl_bound_indexed_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.kl_bound_indexed_launch.restype = ctypes.c_int
        lib.kl_bounds_pair_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
            ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float,
                                                               ctypes.c_void_p]
        lib.kl_bounds_pair_launch.restype = ctypes.c_int
        _library = lib
    return _library


def _newton(_sum, count, threshold, lower: bool, iters: int, eps: float):
    """The solve in plain tensor ops; returns the bound and each element's
    number of Newton trips (the trip that froze it included)."""
    safe = torch.clamp(count, min=1.0)
    mu = _sum / safe
    max_div = threshold / safe
    a = torch.zeros_like(mu) if lower else mu
    b = mu if lower else torch.ones_like(mu)
    x = (a + b) / 2
    frozen = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    trips = torch.zeros(mu.shape, dtype=torch.int64, device=mu.device)
    for _ in range(iters):
        f_x = bernoulli_kullback_leibler(mu, x) - max_div
        df_x = d_bernoulli_kullback_leibler_dq(mu, x)
        x_next = _bounded_newton_step(x, f_x, df_x, a, b)
        trips += ~frozen
        newly = torch.abs(x_next - x) <= eps
        x = torch.where(frozen, x, x_next)
        frozen = frozen | newly
        if bool(frozen.all()):  # frozen elements never move again
            break
    x = torch.minimum(torch.maximum(x, a), b)
    x = torch.where(a == b, a, x)
    return torch.where(count == 0, 0.0 if lower else 1.0, x), trips


def kl_bound_torch(_sum, count, threshold, lower: bool = False, iters: int = 24,
                   eps: float = 1e-2) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same trips, freeze rule and edge
    cases, on f32 tensors of one broadcast shape."""
    return _newton(_sum, count, threshold, lower, iters, eps)[0]


def kl_bound_trips(_sum, count, threshold, lower: bool = False, iters: int = 24,
                   eps: float = 1e-2) -> torch.Tensor:
    """Newton trips each element takes: the data-dependent work of a launch."""
    return _newton(_sum, count, threshold, lower, iters, eps)[1]


def _as_input(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        if value.device != device:
            raise ValueError(f"kl_bound: input on {value.device}, expected {device}")
        return value.to(torch.float32)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def kl_bound(_sum, count, threshold, lower: bool = False, iters: int = 24,
             eps: float = 1e-2, device="cuda") -> torch.Tensor:
    """KL-UCB (or LCB with ``lower=True``) of empirical Bernoulli means.

    Inputs broadcast against each other and are taken as float32. Tensors
    must already lie on ``device``; other values are placed there. On a CUDA
    device this launches the kernel on the current stream (and counts the
    launch in ``kl_bound.launches``) or raises; on the CPU it runs
    ``kl_bound_torch``.
    """
    device = resolve_device(device)
    s, n, t = torch.broadcast_tensors(*(_as_input(v, device) for v in (_sum, count, threshold)))
    if device.type == "cpu":
        return kl_bound_torch(s, n, t, lower=lower, iters=iters, eps=eps)
    if device.type != "cuda":
        raise ValueError(f"kl_bound: unsupported device {device}")
    s, n, t = s.contiguous(), n.contiguous(), t.contiguous()
    out = torch.empty(s.shape, dtype=torch.float32, device=s.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.kl_bound_launch(s.data_ptr(), n.data_ptr(), t.data_ptr(), out.data_ptr(),
                                  out.numel(), int(lower), int(iters), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"kl_bound kernel launch failed with CUDA error {err}")
    kl_bound.launches += 1
    return out


kl_bound.launches = 0


def kl_bound_indexed_torch_(out, _sum, count, nodes, threshold, lower: bool = False,
                            iters: int = 24, eps: float = 1e-2) -> torch.Tensor:
    """Plain PyTorch version of the indexed kernel: gather the path's nodes,
    solve them with ``kl_bound_torch``, scatter the bounds into ``out``. A
    node outside ``[0, N)`` raises (``gather`` does not wrap negatives)."""
    per_tree = nodes.t()
    bounds = kl_bound_torch(_sum.gather(1, per_tree), count.gather(1, per_tree).to(torch.float32),
                            threshold, lower=lower, iters=iters, eps=eps)
    return out.scatter_(1, per_tree, bounds)


_INDEXED_ARGS = (("out", torch.float32, 2), ("sum", torch.float32, 2),
                 ("count", torch.int64, 2), ("nodes", torch.int64, 2),
                 ("threshold", torch.float32, 0))


def _check_indexed(out, _sum, count, nodes, threshold) -> torch.device:
    args = (out, _sum, count, nodes, threshold)
    for value, (name, dtype, dim) in zip(args, _INDEXED_ARGS):
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"kl_bound_indexed_: {name} must be a tensor, got {type(value).__name__}")
        if value.dtype != dtype or value.dim() != dim:
            raise TypeError(f"kl_bound_indexed_: {name} must be {dim}-d {dtype}, "
                            f"got {value.dim()}-d {value.dtype}")
        if not value.is_contiguous():
            raise ValueError(f"kl_bound_indexed_: {name} must be contiguous")
    devices = {value.device for value in args}
    if len(devices) != 1:
        raise ValueError(f"kl_bound_indexed_: inputs on {sorted(map(str, devices))}, "
                         "expected one device")
    if _sum.shape != out.shape or count.shape != out.shape:
        raise ValueError(f"kl_bound_indexed_: out, sum and count must share one [B, N] shape, "
                         f"got {tuple(out.shape)}, {tuple(_sum.shape)}, {tuple(count.shape)}")
    if nodes.shape[1] != out.shape[0]:
        raise ValueError(f"kl_bound_indexed_: nodes must be [H, {out.shape[0]}], "
                         f"got {tuple(nodes.shape)}")
    return out.device


def kl_bound_indexed_(out, _sum, count, nodes, threshold, lower: bool = False,
                      iters: int = 24, eps: float = 1e-2) -> torch.Tensor:
    """KL-UCB (or LCB with ``lower=True``) of the nodes of one planning
    episode's path, written into ``out`` in place; returns ``out``.

    ``out`` and ``sum`` are ``[B, N]`` float32 arenas, ``count`` is ``[B, N]``
    int64, ``nodes`` is ``[H, B]`` int64 (row ``h`` holds the node at depth
    ``h + 1`` of every tree) and ``threshold`` a 0-d float32 tensor, all
    contiguous on one device. For every ``(h, b)`` the bound of
    ``sum[b, nodes[h, b]] / count[b, nodes[h, b]]`` lands in
    ``out[b, nodes[h, b]]``; other entries are left as they are. Nodes lie in
    ``[0, N)``. The planner's nodes of one tree are distinct, one per depth; a
    repeated node would be solved twice from the same inputs and get the same
    value.

    On a CUDA device this launches the kernel on the current stream (and
    counts the launch in ``kl_bound_indexed_.launches``) or raises; a node
    outside ``[0, N)`` stops the kernel with a device error, as an
    out-of-range index does in PyTorch. On the CPU it runs
    ``kl_bound_indexed_torch_``, which raises on such a node.
    """
    device = _check_indexed(out, _sum, count, nodes, threshold)
    if device.type == "cpu":
        return kl_bound_indexed_torch_(out, _sum, count, nodes, threshold, lower=lower,
                                       iters=iters, eps=eps)
    if device.type != "cuda":
        raise ValueError(f"kl_bound_indexed_: unsupported device {device}")
    if nodes.numel() == 0:
        return out
    if out.data_ptr() == _sum.data_ptr():  # the kernel takes them as __restrict__
        raise ValueError("kl_bound_indexed_: out must not alias sum")
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kl_bound_indexed_launch(
            _sum.data_ptr(), count.data_ptr(), nodes.data_ptr(), threshold.data_ptr(),
            out.data_ptr(), out.shape[0], out.shape[1], nodes.numel(), int(lower), int(iters),
            float(eps), stream)
    if err != 0:
        raise RuntimeError(f"kl_bound_indexed_ kernel launch failed with CUDA error {err}")
    kl_bound_indexed_.launches += 1
    return out


kl_bound_indexed_.launches = 0


def kl_bounds_pair_torch_(ucb, lcb, _sum, count, at, threshold, mask=None,
                          iters: int = NEWTON_MAX_ITERATIONS, eps: float = 1e-2):
    """Plain PyTorch version of the paired kernel: gather the entries at the
    offsets, solve the upper and then the lower bound with ``kl_bound_torch``,
    scatter both under the mask; returns ``(ucb, lcb)``. Masked-out trees are
    neither read nor checked. An offset outside its tree's row raises
    (``gather`` does not wrap negatives), and so does a count outside the
    threshold table."""
    trees = _sum.shape[0]
    row = lambda t: t.view(trees, -1)
    per_tree = at.reshape(-1, trees).t()
    if mask is not None:  # a masked-out tree reads and writes back its entry 0
        per_tree = torch.where(mask[:, None], per_tree, 0)
    n = row(count).gather(1, per_tree)
    if threshold.dim() == 1:
        outside = (n < 0) | (n >= threshold.numel())
        if mask is not None:
            outside &= mask[:, None]
        if bool(outside.any()):
            raise IndexError(f"kl_bounds_pair_: a count outside the threshold table of "
                             f"{threshold.numel()} entries")
        threshold = threshold[n.clamp(0, threshold.numel() - 1)]
    s, n = row(_sum).gather(1, per_tree), n.to(torch.float32)
    bounds = (kl_bound_torch(s, n, threshold, lower=False, iters=iters, eps=eps),
              kl_bound_torch(s, n, threshold, lower=True, iters=iters, eps=eps))
    for out, bound in zip((ucb, lcb), bounds):
        if mask is not None:
            bound = torch.where(mask[:, None], bound, row(out).gather(1, per_tree))
        row(out).scatter_(1, per_tree, bound)
    return ucb, lcb


_PAIR_ARGS = (("ucb", torch.float32), ("lcb", torch.float32), ("sum", torch.float32),
              ("count", torch.int64), ("at", torch.int64), ("threshold", torch.float32))


def _check_pair(args, mask) -> torch.device:
    device = args[0].device
    for value, (name, dtype) in zip(args, _PAIR_ARGS):
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"kl_bounds_pair_: {name} must be a tensor, got {type(value).__name__}")
        if value.dtype != dtype:
            raise TypeError(f"kl_bounds_pair_: {name} must be {dtype}, got {value.dtype}")
        if value.device != device:
            raise ValueError(f"kl_bounds_pair_: {name} on {value.device}, expected {device} "
                             "as ucb: one device")
        if not value.is_contiguous():
            raise ValueError(f"kl_bounds_pair_: {name} must be contiguous")
    ucb, lcb, _sum, count, at, threshold = args
    shape = ucb.shape
    if len(shape) < 1 or lcb.shape != shape or _sum.shape != shape or count.shape != shape:
        raise ValueError(f"kl_bounds_pair_: ucb, lcb, sum and count must share one [B, ...] "
                         f"shape, got {tuple(shape)}, {tuple(lcb.shape)}, {tuple(_sum.shape)}, "
                         f"{tuple(count.shape)}")
    if at.dim() not in (1, 2) or at.shape[-1] != shape[0]:
        raise ValueError(f"kl_bounds_pair_: at must be [{shape[0]}] or [H, {shape[0]}], "
                         f"got {tuple(at.shape)}")
    if threshold.dim() > 1 or threshold.numel() == 0:
        raise ValueError(f"kl_bounds_pair_: threshold must be 0-d or a non-empty 1-d table, "
                         f"got shape {tuple(threshold.shape)}")
    if mask is not None:
        if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool \
                or mask.shape != shape[:1] or mask.device != device or not mask.is_contiguous():
            raise ValueError(f"kl_bounds_pair_: mask must be a contiguous [{shape[0]}] bool "
                             f"tensor on {device}")
    return device


def kl_bounds_pair_(ucb, lcb, _sum, count, at, threshold, mask=None,
                    iters: int = NEWTON_MAX_ITERATIONS, eps: float = 1e-2):
    """KL-UCB and KL-LCB of the arena entries at the offsets ``at``, written
    into ``ucb`` and ``lcb`` in place; returns ``(ucb, lcb)``.

    ``ucb``, ``lcb`` and ``sum`` are float32 arenas and ``count`` an int64
    arena of one shape ``[B, ...]``; ``at`` is ``[B]`` or ``[H, B]`` int64 flat
    offsets into one tree's row (the ``...`` part, row-major), element ``i``
    of its flattened order belonging to tree ``i % B``; ``threshold`` is a
    0-d float32 tensor, or a 1-d float32 table read at each entry's count;
    ``mask`` is ``None`` or ``[B]`` bool (a False tree is neither read nor
    written). All lie contiguous on one device. For every entry of a kept
    tree, ``ucb`` and ``lcb`` there become the upper and the lower bound of
    ``sum / count`` at that threshold, as ``kl_bound`` computes them at
    ``iters`` and ``eps`` (the defaults are ``kl_upper_bound``'s); nothing
    else changes. An offset repeated in one tree is solved twice from the
    same inputs and gets the same values.

    On a CUDA device this launches the kernel on the current stream (and
    counts the launch in ``kl_bounds_pair_.launches``) or raises: an offset
    outside the row or a count outside the table stops the kernel with a
    device error. The launch reads nothing back and allocates nothing, so a
    CUDA graph can capture it. On the CPU it runs ``kl_bounds_pair_torch_``.
    """
    args = (ucb, lcb, _sum, count, at, threshold)
    device = _check_pair(args, mask)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"kl_bounds_pair_: unsupported device {device}")
    if len({ucb.data_ptr(), lcb.data_ptr(), _sum.data_ptr()}) != 3:  # __restrict__ in the kernel
        raise ValueError("kl_bounds_pair_: ucb, lcb and sum must be three arenas")
    if device.type == "cpu":
        return kl_bounds_pair_torch_(ucb, lcb, _sum, count, at, threshold, mask, iters=iters,
                                     eps=eps)
    if at.numel() == 0:
        return ucb, lcb
    lib = _load()
    table = threshold.numel() if threshold.dim() == 1 else 0
    # the raw handle of the current stream: torch.cuda.current_stream() would
    # build a Stream object on every call
    launch = lambda: lib.kl_bounds_pair_launch(
        _sum.data_ptr(), count.data_ptr(), at.data_ptr(),
        None if mask is None else mask.data_ptr(), threshold.data_ptr(), table,
        ucb.data_ptr(), lcb.data_ptr(), ucb.shape[0], ucb.numel() // ucb.shape[0], at.numel(),
        int(iters), float(eps), torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"kl_bounds_pair_ kernel launch failed with CUDA error {err}")
    kl_bounds_pair_.launches += 1
    return ucb, lcb


kl_bounds_pair_.launches = 0
