"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result line.

``run`` takes the cell's name and finds everything else by name: the cell
in ``BENCHMARK.json``, its configuration file, its traffic mix (a data
file whose ``kind`` names the loop in ``perfbench/loops/``), the env
adapter of the configuration's env id (``perfbench/envs/``), the planner
adapter the configuration names (``perfbench/planners/``), and one reader
a per-layer metric (``perfbench/metrics/<name>.py``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

from perfbench.pbcore import profiling
from perfbench.pbcore.manifest import Manifest, peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rl_agents_tpu")


class Context:
    """What a loop is given: the cell's configuration, its traffic mix, the
    env adapter (by the configuration's env id), the planner adapter, the
    env's parameters, the seed and the device. ``scale`` shrinks the cell for
    a rehearsal on the CPU (the tests), never in a measured run."""

    def __init__(self, manifest: Manifest, cell: dict, seed: int, device, scale: dict | None):
        self.config = manifest.config(cell["config"])
        self.traffic = dict(manifest.traffic(cell["traffic"]), **(scale or {}))
        self.env = manifest.module("envs", self.config["env"]["id"])
        self.model = self.env.model(self.config["env"])
        self.planner = manifest.module("planners", self.config["planner"])
        self.seed = seed
        self.device = device


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
        started: float, scale: dict | None = None, program=None) -> dict:
    """Run the cell and return its result line, its compared numbers and its
    seconds (``{"result", "checks", "timing"}``).
    ``started`` is the process's start on the wall clock (``time.time()``),
    from which set-up is counted. ``program`` replaces the loop's view of
    the program (the tests plant faults through it)."""
    import torch

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    ctx = Context(manifest, cell, seed, device, scale)
    loop = manifest.module("loops", ctx.traffic["kind"]).Loop(ctx, program)
    built = time.time()
    loop.setup()
    warm = time.time()
    loop.warm_up()
    window_started = time.time()
    setup_s = window_started - started
    measured = loop.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": None, "attempted": measured["attempted"], "failed": 0}
    if trace:
        record = loop.trace()
        record["peaks"] = peaks(kind)
        metrics = {}
        for entry in manifest.per_layer(workload):
            value = manifest.module("metrics", entry["name"]).read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        segments = record["segments"]
        device_info["busy_s"] = sum(profiling.busy_us(s) for s in segments) / 1e6
        device_info["window_s"] = sum(profiling.traced_window(s) for s in segments) / 1e6
        breakdown = profiling.breakdown(segments)
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {entry["name"]: {"value": values[entry["name"]], "unit": entry["unit"]}
                   for entry in manifest.end_to_end(workload)}
        breakdown = None
    loop.release()
    checked = time.time()
    checks = loop.check()
    timing = {"setup": setup_s, "to the loop": built - started, "build": warm - built,
              "warm-up": window_started - warm, "window and trace": checked - window_started,
              "check": time.time() - checked}
    timing.update(halves(measured["spread"]))
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = checks
    return {"result": result, "checks": checks, "timing": timing}


def halves(seconds: list) -> dict:
    """The window's steps or plans: their count, the first (a shape left cold
    by the warm-up shows there), their median, and the mean of the first and
    of the second half, in seconds (drift within a run)."""
    import statistics

    half = len(seconds) // 2
    return {"window's items": len(seconds), "first item": seconds[0],
            "median item": statistics.median(seconds),
            "first half mean": statistics.fmean(seconds[:half] or seconds),
            "second half mean": statistics.fmean(seconds[half:])}


def report(outcome: dict, card: str):
    """The card's line, each compared number beside its limit (the last
    lines of standard error), and the result (the last line of standard
    output)."""
    print(f"card: {card}", file=sys.stderr)
    print("seconds: " + ", ".join(f"{k} {v:.4g}" for k, v in outcome["timing"].items()),
          file=sys.stderr)
    for name, check in outcome["checks"].items():
        verdict = "ok" if check["value"] <= check["limit"] else "FAILED"
        print(f"compared {name}: {check['value']!r} limit {check['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome["result"]), flush=True)
