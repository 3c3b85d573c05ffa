"""The share, in %, of the spanned pass's highway transitions that replayed
a CUDA graph (the program's ``env.transition_graph.*`` counters): replays
over replays, captures and eager calls. None where the program has no
such counters."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    calls = {k: made["counters"].get(f"env.transition_graph.{k}", 0)
             for k in ("replays", "captures", "eager")}
    total = sum(calls.values())
    return 100.0 * calls["replays"] / total if total else None
