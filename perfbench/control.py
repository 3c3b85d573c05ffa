"""The control of a cell: its plain reference computed in the precision
below the one its configuration states (bfloat16 for float32), put in the
program's place and judged by the same comparison as a run. Every compared
number it gives is a reading from which the cell's limits are set; the
control has to come out as not correct. The benchmark's runs never run it.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

``--seconds`` is the window of the program's own loop whose states an
agent cell's control is judged at. Prints one JSON line a seed.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, seed: int, seconds: float, device, scale=None) -> dict:
    import torch

    from perfbench.pbcore.cell import Context
    from perfbench.pbcore.manifest import Manifest

    manifest = Manifest(root)
    ctx = Context(manifest, manifest.cell(workload), seed, device, scale)
    loop = manifest.module("loops", ctx.traffic["kind"]).Loop(ctx)
    return loop.control(torch.bfloat16, seconds)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("the control is read on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        started = time.time()
        checks = readings(ROOT, args.workload, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": all(c["value"] <= c["limit"] for c in checks.values()),
                          "compared": checks, "seconds": time.time() - started}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
