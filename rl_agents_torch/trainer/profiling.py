"""Tracing and per-phase timing.

Port of ``rl_agents_tpu/trainer/profiling.py``: per-phase wall timers that
feed the metrics writer (``time/{name}_mean_s`` and ``time/{name}_total_s``),
a ``torch.profiler`` trace written as a Chrome trace, and per-card memory
statistics under the JAX package's keys.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


class PhaseTimer:
    """Accumulates wall time per named phase; writes mean durations."""

    def __init__(self, writer=None):
        self.writer = writer
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def flush(self, step: int):
        if self.writer is None:
            return
        for name in self.totals:
            self.writer.add_scalar(f"time/{name}_mean_s", self.mean(name), step)
            self.writer.add_scalar(f"time/{name}_total_s", self.totals[name], step)


@contextlib.contextmanager
def trace(directory: str | Path):
    """Trace the block with ``torch.profiler`` (host activity, and the
    cards' when CUDA is available) and write ``trace.json``, a Chrome trace
    (Perfetto or chrome://tracing), into ``directory``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(directory / "trace.json"))


def device_memory_stats() -> dict:
    """Per-card memory statistics (the reference regexes nvidia-smi,
    common/utils.py:70-107): ``bytes_in_use`` and ``peak_bytes_in_use`` of
    PyTorch's caching allocator, and ``bytes_limit``, the card's memory.
    Empty without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return stats
