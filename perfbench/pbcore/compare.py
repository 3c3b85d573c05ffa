"""The numbers that decide ``correct``: what the timed path produced against
the plain reference on the same inputs, each beside its limit."""
from __future__ import annotations

import torch

BIG = 1e300  # what a missing or non-finite gap is reported as


def gap(got, want) -> float:
    """The largest absolute difference of two tensors of one shape (equal
    infinities count as equal); ``BIG`` where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return BIG
    a, b = got.to(want.device).double(), want.double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    if d.numel() == 0:
        return 0.0
    value = float(d.max())
    return value if value == value and value < BIG else BIG


def rows_differing(got, want) -> torch.Tensor:
    """``[B]``: whether row b of ``got`` differs anywhere from ``want``'s."""
    if tuple(got.shape) != tuple(want.shape):
        return torch.ones(want.shape[0], dtype=torch.bool, device=want.device)
    return (got.to(want.device) != want).reshape(want.shape[0], -1).any(dim=1)


def checked(values: dict, limits: dict) -> dict:
    return {name: {"value": values[name], "limit": limits[name]} for name in limits}


def batch_checks(planner, out: dict, want: dict, limits: dict) -> dict:
    """Trees whose structure differs anywhere (exact: actions, lengths, the
    arena's links, depths, counts and flags), the widest gap of the arena's
    values, and, where the arena holds scenes, of the scenes."""
    differ = torch.zeros(want["actions"].shape[0], dtype=torch.bool,
                         device=want["actions"].device)
    for field in planner.DISCRETE:
        differ |= rows_differing(out[field], want[field])
    values = {"trees_differing": int(differ.sum()),
              "value_gap": max(gap(out[f].float(), want[f].float()) for f in planner.FLOATS)}
    if planner.STATES:
        values["state_gap"] = max(gap(a, b) for a, b in zip(out["states"], want["states"]))
    return checked(values, limits)
