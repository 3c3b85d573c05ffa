"""Masked Newton trips of the chance backups' constrained solves (the
program's ``newton_iteration.trips`` counter) per ``planner.plan`` span of
the spanned pass's whole plans. None where the program records no plan
span or no trip."""
from perfbench.pbcore.spans import program


def read(record):
    made = program(record)
    if made is None:
        return None
    plans = sum(s.name == "planner.plan" for s in made["spans"])
    trips = made["counters"].get("newton_iteration.trips", 0)
    return trips / plans if plans and trips else None
