"""Device activity of a bounded segment of work, from ``torch.profiler``.

A segment is profiled with the device's activity only (the host's
operators would triple the records and slow the launches they measure),
and reduced at once to its kernels' names and intervals. On the CPU (the
rehearsal of a run in the tests) the top-level operators stand in for
kernels, so that every reader's path runs; no CPU number is ever reported
as a device number, since a run without a card prints no result.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

NAME_LENGTH = 160
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::", "c10::")


def short_name(name: str) -> str:
    """A kernel's name without the namespaces and qualifiers every ATen
    kernel shares, cut to ``NAME_LENGTH``."""
    for word in NOISE:
        name = name.replace(word, "")
    return name[:NAME_LENGTH]


class Segment(NamedTuple):
    label: str
    units: int          # how much of a whole plan or loop ran (episodes, expansions, steps)
    full_units: int     # the same for the whole of it
    kernels: list       # (name, start_us, end_us), sorted by start
    wall_us: float


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(label: str, run, device: torch.device, units: int, full_units: int) -> Segment:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = device.type == "cuda"
    synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        started = time.perf_counter()
        run()
        synchronize(device)
        wall_us = (time.perf_counter() - started) * 1e6
    kernels = []
    for event in prof.events():
        if cuda and event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if not cuda and event.cpu_parent is not None:
            continue
        kernels.append((short_name(event.name), float(event.time_range.start),
                        float(event.time_range.end)))
    kernels.sort(key=lambda k: k[1])
    return Segment(label, units, full_units, kernels, wall_us)


def busy_us(segment: Segment) -> float:
    """The union of the segment's kernel intervals."""
    total, end = 0.0, float("-inf")
    for _, start, stop in segment.kernels:
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def idle_percent(segments: list):
    """The device's idle share of the traced segments that launched kernels:
    1 - the union of their kernel intervals over their traced window; None
    where none did."""
    segments = [s for s in segments if s.kernels]
    if not segments:
        return None
    return 100.0 * (1.0 - sum(map(busy_us, segments)) / sum(map(traced_window, segments)))


def traced_window(segment: Segment) -> float:
    """The segment's length: the host's wall time around it, or the span of
    its kernels where that is longer (the two clocks differ)."""
    if not segment.kernels:
        return segment.wall_us
    span = max(k[2] for k in segment.kernels) - segment.kernels[0][1]
    return max(segment.wall_us, span)


def breakdown(segments: list, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps between
    kernels summed by the kernel the host launched next (what it was
    preparing while the device waited), in seconds."""
    ops, gaps = {}, {}
    for segment in segments:
        end = None
        for name, start, stop in segment.kernels:
            ops[name] = ops.get(name, 0.0) + (stop - start) / 1e6
            if end is not None and start > end:
                key = f"before {name}"
                gaps[key] = gaps.get(key, 0.0) + (start - end) / 1e6
            end = stop if end is None else max(end, stop)
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
