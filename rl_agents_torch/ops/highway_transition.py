"""The meta-action, single-ego highway transition as one CUDA kernel
(``csrc/highway_transition.cu``): the whole of ``envs/highway.py::
HighwayEnv._transition_eager`` in one launch, the same bits.

It replaces no TPU kernel: the JAX package leaves this transition to XLA,
which fuses it, while the port's eager body launches about 314 small
kernels a call. ``_transition_eager`` stays the plain version: it runs on
the CPU, and ``HighwayEnv.transition`` decides which calls launch the kernel.

``launch`` allocates the outputs as one byte buffer carved into typed views
and makes one ``ctypes`` call; it reads nothing back and copies nothing from
the host, so a call is legal inside someone else's CUDA-graph capture. The
form of a params object (``_params_form``) is worked out once per object and
row count. Each launch counts in ``counters["env.transition_kernel.launches"]``.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from rl_agents_torch.envs.base import StepOut
from rl_agents_torch.ops import cuda_build
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils.math import recip

SOURCE = cuda_build.PACKAGE / "csrc" / "highway_transition.cu"
MAX_VEHICLES = 32

# the params fields the kernel reads, in the kernel's Field order, and the
# width of one model's value of each (0: a scalar)
PARAM_FIELDS = ("dt", "target_speeds", "idm_t0", "idm_a", "idm_b", "idm_s0",
                "speed_reward_range", "collision_reward", "right_lane_reward",
                "high_speed_reward", "mobil_politeness", "mobil_min_gain", "mobil_b_safe")
WIDTHS = (0, 3, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0)
_fields = operator.attrgetter(*PARAM_FIELDS)
_ONE_MODEL_DIMS = [1 if w else 0 for w in WIDTHS]
_VECTORS = [(k, w) for k, w in enumerate(WIDTHS) if w]
_ALL_F32 = [torch.float32] * len(PARAM_FIELDS)
STATE_DTYPES = [torch.float32, torch.float32, torch.int64, torch.float32, torch.int64,
                torch.bool, torch.bool, torch.int64]

_library = None
# (id(params), rows) -> (params, form): the params object is held, so that
# its id names no other object while its entry lasts
_forms = {}
_FORMS_KEPT = 64


def build():
    """Build the kernel's shared library if it is not built yet; return its
    path (``ops/cuda_build.py::build``)."""
    return cuda_build.build(SOURCE, "highway_transition")


def _load():
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        lib.highway_transition_launch.argtypes = (
            [ctypes.c_void_p] * (9 + len(PARAM_FIELDS)) + [ctypes.c_uint, ctypes.c_void_p,
                                                           ctypes.c_longlong, ctypes.c_int,
                                                           ctypes.c_int, ctypes.c_longlong,
                                                           ctypes.c_float, ctypes.c_float,
                                                           ctypes.c_void_p])
        lib.highway_transition_launch.restype = ctypes.c_int
        _library = lib
    return _library


def _per_row(fields, rows: int):
    """The kernel's ``per_row`` mask of the params ``fields`` (bit k: field k
    holds one value a row), or None where a field has another form than one
    model's float32 value (with or without a leading axis of 1) or one a
    row."""
    if [f.dtype for f in fields] != _ALL_F32:
        return None
    if ([f.dim() for f in fields] == _ONE_MODEL_DIMS
            and all(fields[k].shape[0] == width for k, width in _VECTORS)):
        return 0
    mask = 0
    for k, (width, value) in enumerate(zip(WIDTHS, fields)):
        if width and value.shape[-1:] != (width,):
            return None
        leading = value.shape[:-1] if width else value.shape
        if len(leading) > 1 or leading and leading[0] not in (1, rows):
            return None
        if leading and leading[0] != 1:
            mask |= 1 << k
    return mask


def _params_form(params, rows: int):
    """``(per_row, device, contiguous)`` of ``params`` at ``rows`` rows: the
    ``_per_row`` mask, the CUDA device index that holds every field (-1
    where they are not all on one) and whether every field is contiguous.
    Worked out once per params object and row count, since no field's
    shape, dtype, device or strides change in place."""
    key = (id(params), rows)
    entry = _forms.get(key)
    if entry is not None and entry[0] is params:
        return entry[1]
    fields = _fields(params)
    devices = {f.get_device() for f in fields}
    device = devices.pop() if len(devices) == 1 else -1
    form = (_per_row(fields, rows), device, all(f.is_contiguous() for f in fields))
    if len(_forms) >= _FORMS_KEPT:
        _forms.clear()
    _forms[key] = (params, form)
    return form


def wants_grad(params, state, action) -> bool:
    """Whether grad would flow into an input: the kernel computes no
    gradient."""
    return torch.is_grad_enabled() and any([t.requires_grad
                                            for t in (*state, action, *_fields(params))])


def declines(params, state, action, vehicles: int):
    """Why the kernel cannot take these tensors, or None where it can: a
    state of ``vehicles`` (1 to ``MAX_VEHICLES``) vehicles with the
    ``HighwayState`` dtypes and shapes, one action a row, every params field
    one model's float32 value or one a row, all on one CUDA device. The
    device is tested last, so that on the CPU the other reasons show. Grad is
    not tested here (``wants_grad``)."""
    x = state.x
    if x.dim() != 2 or x.shape[1] != vehicles or not 1 <= vehicles <= MAX_VEHICLES:
        return f"a state of shape {tuple(x.shape)}: the kernel takes 1 to {MAX_VEHICLES} vehicles"
    rows = x.shape[0]
    if [t.dtype for t in state] != STATE_DTYPES:
        return "state dtypes"
    scene, one = (rows, vehicles), (rows,)
    if [t.shape for t in state] != [scene, scene, scene, scene, one, scene, one, one]:
        return "state shapes"
    if action.numel() != rows:
        return "not one action a row"
    per_row, params_device, _ = _params_form(params, rows)
    if per_row is None:
        return "params form"
    device = x.get_device()
    if (device < 0 or params_device != device
            or [t.get_device() for t in (*state, action)].count(device) != len(state) + 1):
        return "not all on one CUDA device"
    return None


def launch(params, state, action, lanes: int, max_episode_steps: int,
           inv_v0: float) -> StepOut:
    """One transition of ``state`` under the meta-actions ``action`` on a road
    of ``lanes`` lanes, where ``declines`` gives None; ``inv_v0`` is the
    float32 reciprocal of the traffic's IDM target speed. The ``StepOut`` has
    the eager's fields, dtypes, shapes and aliasing: ``state.alive`` is the
    input's, and ``crashed``, ``terminated`` and ``info["crashed"]`` are one
    tensor."""
    rows, vehicles = state.x.shape
    device = state.x.device
    per_row, _, contiguous = _params_form(params, rows)
    fields = _fields(params)
    # held until the launch: a copy made here must not be freed before it
    inputs = [t.contiguous() for t in state]
    if action.dtype is not torch.int64 or action.dim() != 1:
        action = action.reshape(rows).to(torch.int64)
    inputs.append(action.contiguous())
    inputs += fields if contiguous else [f.contiguous() for f in fields]

    buffer, out = _outputs(state, rows, vehicles)
    args = (*[t.data_ptr() for t in inputs], per_row, buffer.data_ptr(), rows, vehicles, lanes,
            max_episode_steps, inv_v0, _lane_weight(lanes),
            # torch.cuda.current_stream(device).cuda_stream without its Stream object
            torch._C._cuda_getCurrentRawStream(device.index))
    lib = _load()
    if device.index == torch.cuda.current_device():
        err = lib.highway_transition_launch(*args)
    else:
        with torch.cuda.device(device):
            err = lib.highway_transition_launch(*args)
    if err != 0:
        raise RuntimeError(f"highway_transition kernel launch failed with CUDA error {err}")
    counters["env.transition_kernel.launches"] += 1
    return out


def _outputs(state, rows: int, vehicles: int):
    """The kernel's output buffer, one allocation laid out as
    ``csrc/highway_transition.cu`` reads it (int64 target lanes, speed levels
    and step counts; float32 x, lane, speed, reward, the ego's speed, cost and
    observation; bool crashed and truncated), and the ``StepOut`` of typed
    views into it."""
    n = rows * vehicles
    ints = n + 2 * rows             # int64 elements
    floats = 2 * ints               # float32 offset of x
    flags = 4 * (floats + 3 * n + 4 * rows)  # byte offset of crashed
    buffer = torch.empty(-(-(flags + 2 * rows) // 8) * 8, dtype=torch.uint8,
                         device=state.x.device)
    as_i64, as_f32, as_bool = (buffer.view(torch.int64), buffer.view(torch.float32),
                               buffer.view(torch.bool))
    x, lane, speed = as_f32.as_strided((3, rows, vehicles), (n, vehicles, 1), floats).unbind(0)
    reward, ego_speed, cost = as_f32.as_strided((3, rows), (rows, 1), floats + 3 * n).unbind(0)
    obs = as_f32.as_strided((rows, 1), (1, 1), floats + 3 * n + 3 * rows)
    target_lane = as_i64.as_strided((rows, vehicles), (vehicles, 1), 0)
    speed_level = as_i64.as_strided((rows,), (1,), n)
    t = as_i64.as_strided((rows,), (1,), n + rows)
    crashed = as_bool.as_strided((rows,), (1,), flags)
    truncated = as_bool.as_strided((rows,), (1,), flags + rows)
    new_state = type(state)(x, lane, target_lane, speed, speed_level, state.alive, crashed, t)
    out = StepOut(new_state, obs, reward, crashed, truncated,
                  {"crashed": crashed, "speed": ego_speed, "cost": cost})
    return buffer, out


@functools.lru_cache(maxsize=None)
def _lane_weight(lanes: int) -> float:
    """The eager reward's right-lane factor ``recip(max(lanes - 1, 1))``."""
    return recip(max(lanes - 1, 1))
