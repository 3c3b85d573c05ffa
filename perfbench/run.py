"""Run one cell of the benchmark once on the card(s) of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads, warms up, measures for ``--seconds``,
then (``--trace 1``) profiles a bounded segment, compares what the timed
path produced with the plain reference, and prints one JSON line as the
last line of standard output. Without a CUDA device, or with fewer than
the cell asks for, it fails and prints no result.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def process_started() -> float:
    """This process's start on the wall clock, from ``/proc`` (to 10 ms)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_started()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # one host thread for the CPU's share of the work: the loops launch work
    # on the card, and idle worker threads spinning beside the launching one
    # slow it by about a sixth on an 8-core host
    os.environ["OMP_NUM_THREADS"] = "1"
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)
    from perfbench.pbcore import cell
    from perfbench.pbcore.manifest import Manifest

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import rl_agents_torch

    if ROOT not in Path(rl_agents_torch.__file__).resolve().parents:
        print(f"rl_agents_torch comes from {rl_agents_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    outcome = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device,
                       STARTED)
    found = cell.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    cell.report(outcome, cell.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
