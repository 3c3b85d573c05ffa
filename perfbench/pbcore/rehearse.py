"""A run of a cell on the CPU at a small size, through every code path of a
measured run but the look for a card: the tests drive it. Its numbers are
the CPU's, and nothing prints them as a result."""
from __future__ import annotations

import time
from pathlib import Path

import torch

from perfbench.pbcore import cell

SMALL = {"agent_loop": {"warmup_steps": 1, "scene_pool": 64},
         "batch_plan": {"trees": 8, "transition_calls": 2}}


def rehearse(root: Path, workload: str, seed: int, seconds: float = 0.2, trace: bool = False,
             program=None, scale: dict | None = None) -> dict:
    from perfbench.pbcore.manifest import Manifest

    manifest = Manifest(root)
    kind = manifest.traffic(manifest.cell(workload)["traffic"])["kind"]
    return cell.run(Path(root), workload, seed, seconds, trace, torch.device("cpu"), time.time(),
                    scale=dict(SMALL[kind], **(scale or {})), program=program)
