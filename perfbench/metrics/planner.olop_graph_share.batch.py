"""The share, in %, of the spanned pass's KL-OLOP episodes that replayed the
episode's CUDA graph: the program's ``olop.episode_graph.replays`` counter
over it and ``olop.episode_eager.calls`` (the episodes run eagerly). None
where neither counter moved, as in a program without them."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    counted = made["counters"]
    replays = counted.get("olop.episode_graph.replays", 0)
    episodes = replays + counted.get("olop.episode_eager.calls", 0)
    return 100.0 * replays / episodes if episodes else None
