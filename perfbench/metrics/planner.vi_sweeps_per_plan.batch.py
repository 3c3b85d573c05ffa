"""Value-iteration sweeps run by the stochastic GBOP planner (the program's
``gbop_stochastic.vi_sweeps`` counter: all graphs together, every sweep a
replayed episode runs) per ``planner.plan`` span of the spanned pass's whole
plans. None where the program records no plan span or no sweep."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    plans = sum(s.name == "planner.plan" for s in made["spans"])
    sweeps = made["counters"].get("gbop_stochastic.vi_sweeps", 0)
    return sweeps / plans if plans and sweeps else None
