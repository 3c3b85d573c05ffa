"""The share, in %, of the spanned pass's constrained solves of the chance
backups (``max_expectation_under_constraint``) that launched the
hand-written solve kernel: the program's
``max_expectation_under_constraint.kernel_launches`` counter over it and
``max_expectation_under_constraint.eager_calls`` (the solves the plain
version ran). None where neither counter moved, as in a program without
them."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    counted = made["counters"]
    launches = counted.get("max_expectation_under_constraint.kernel_launches", 0)
    solves = launches + counted.get("max_expectation_under_constraint.eager_calls", 0)
    return 100.0 * launches / solves if solves else None
