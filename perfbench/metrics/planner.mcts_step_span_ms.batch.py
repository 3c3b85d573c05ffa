"""Host milliseconds of one MCTS step's tree work: the program's
``mcts.select`` and ``mcts.advance`` spans of the spanned pass's whole plans
(the step's work before and after its transition), over the steps its
``mcts.steps`` counter counts. None where the program has no such spans."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    steps = made["counters"].get("mcts.steps", 0)
    spans = [s for s in made["spans"] if s.name in ("mcts.select", "mcts.advance")]
    if not steps or not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / steps / 1e6
