"""The share, in %, of the spanned pass's MCTS episodes that replayed the
episode's CUDA graph: the program's ``mcts.episode_graph.replays`` counter
over it and ``mcts.episode_eager.calls`` (the episodes run eagerly). None
where neither counter moved, as in a program without them."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    counted = made["counters"]
    replays = counted.get("mcts.episode_graph.replays", 0)
    episodes = replays + counted.get("mcts.episode_eager.calls", 0)
    return 100.0 * replays / episodes if episodes else None
