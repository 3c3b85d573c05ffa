"""Milliseconds of one env transition over the rows a step of the cell's
planner steps (every tree, once per action for OPD), called directly on the
cell's own scenes, by CUDA events around a block of calls."""
from statistics import fmean


def read(record):
    spans = record.get("spans", {}).get("env.transition")
    return fmean(spans) * 1e3 if spans else None
