"""The share, in %, of the spanned pass's highway transitions that launched
the hand-written transition kernel (the program's
``env.transition_kernel.launches`` counter): its launches over its launches
and the CUDA-graph path's replays, captures and eager calls
(``env.transition_graph.*``). None where the program has no such kernel."""
from importlib.util import find_spec

from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None or find_spec("rl_agents_torch.ops.highway_transition") is None:
        return None
    counted = made["counters"]
    launches = counted.get("env.transition_kernel.launches", 0)
    total = launches + sum(counted.get(f"env.transition_graph.{k}", 0)
                           for k in ("replays", "captures", "eager"))
    return 100.0 * launches / total if total else None
