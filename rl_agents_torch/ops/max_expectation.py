"""The constrained-KL expectation ``max_p E_p[f] s.t. KL(q || p) <= c`` as
one CUDA kernel (``csrc/max_expectation.cu``): the whole of
``utils/math.py::_max_expectation`` in one launch, one thread a problem,
the same bits.

It replaces no TPU kernel: the JAX package leaves this solve to XLA, while
the port's plain version launches some 50 small kernels a Newton trip over
the whole batch. ``_max_expectation`` stays the plain version: it runs on the
CPU, and ``max_expectation_under_constraint`` sends every call with a CUDA
tensor here.

``launch`` broadcasts its inputs to one ``[..., n]`` shape, allocates the
output and makes one ``ctypes`` call; it reads nothing back and copies
nothing from the host, so a call is legal inside someone else's CUDA-graph
capture. Each launch counts in
``counters["max_expectation_under_constraint.kernel_launches"]``. The shared
library is built from the repository's source with ``nvcc`` at the first
launch into ``rl_agents_torch/_build/``, keyed on a hash of the source and
flags.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from rl_agents_torch.ops import cuda_build
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS, NEWTON_OOB_WEIGHT

SOURCE = cuda_build.PACKAGE / "csrc" / "max_expectation.cu"
# the atom counts n the kernel is built for (kMinAtoms..kMaxAtoms of the
# source), each held bit for bit against the plain version on the card
ATOMS = range(2, 17)

_library = None


def build():
    """Build the kernel's shared library if it is not built yet; return its
    path (``ops/cuda_build.py::build``)."""
    return cuda_build.build(SOURCE, "max_expectation")


def _load():
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.max_expectation_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        lib.max_expectation_launch.restype = ctypes.c_int
        _library = lib
    return _library


def _device(f, q, c) -> torch.device:
    """The one CUDA device of the inputs; raises ``ValueError`` on anything
    the kernel does not take."""
    if not (isinstance(f, torch.Tensor) and isinstance(q, torch.Tensor)):
        raise ValueError("max_expectation: f and q must be tensors")
    if not isinstance(c, (torch.Tensor, numbers.Real)):
        raise ValueError(f"max_expectation: c must be a tensor or a number, got {type(c).__name__}")
    tensors = [v for v in (f, q, c) if isinstance(v, torch.Tensor)]
    for name, value in zip("fqc", tensors):
        if value.dtype != torch.float32:
            raise ValueError(f"max_expectation: {name} must be float32, got {value.dtype}")
    devices = {v.device for v in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"max_expectation: inputs on {sorted(map(str, devices))}, "
                         "expected one CUDA device")
    return f.device


def launch(f, q, c, eps: float = 1e-2) -> torch.Tensor:
    """``max_p E_p[f] s.t. KL(q || p) <= c`` over the last axis of float32
    CUDA tensors ``f`` and ``q`` ``[..., n]`` and ``c`` ``[...]`` (or a
    number), broadcast against each other: one launch, or ``ValueError``
    for another dtype, device or atom count (``ATOMS``, and 1, whose
    solution is all ones)."""
    device = _device(f, q, c)
    n = q.shape[-1]
    if f.shape[-1] != n:
        raise ValueError(f"max_expectation: f has {f.shape[-1]} atoms, q {n}")
    if n == 1:
        # single-atom support: p puts all mass on the sole atom
        return torch.ones_like(q)
    if n not in ATOMS:
        raise ValueError(f"max_expectation: {n} atoms, the kernel takes {ATOMS.start} to "
                         f"{ATOMS.stop - 1}")
    if not isinstance(c, torch.Tensor):
        c = torch.full((), c, dtype=torch.float32, device=device)
    # views, then copies only of what was broadcast (torch.broadcast_shapes
    # would import sympy, seconds at a process's first solve)
    f, q, c = torch.broadcast_tensors(f, q, c[..., None])
    f, q, c = f.contiguous(), q.contiguous(), c[..., 0].contiguous()
    p = torch.empty(f.shape, dtype=torch.float32, device=device)
    problems = c.numel()
    if problems == 0:
        return p
    args = (f.data_ptr(), q.data_ptr(), c.data_ptr(), p.data_ptr(), problems, n, eps,
            NEWTON_MAX_ITERATIONS, NEWTON_OOB_WEIGHT,
            # 1 - 0.9 in double, rounded to float by ctypes as PyTorch rounds the scalar
            1 - NEWTON_OOB_WEIGHT,
            # torch.cuda.current_stream(device).cuda_stream without its Stream object
            torch._C._cuda_getCurrentRawStream(device.index))
    lib = _load()
    if device.index == torch.cuda.current_device():
        err = lib.max_expectation_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.max_expectation_launch(*args)
    if err != 0:
        raise RuntimeError(f"max_expectation kernel launch failed with CUDA error {err}")
    counters["max_expectation_under_constraint.kernel_launches"] += 1
    return p
