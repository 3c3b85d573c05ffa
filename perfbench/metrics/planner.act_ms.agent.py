"""Mean milliseconds of the agent's ``act`` over the traced run's window:
the planner shell and one plan (host clock around each call, which ends by
reading the plan on the host)."""
from statistics import fmean


def read(record):
    spans = record.get("spans", {}).get("agent.act")
    return fmean(spans) * 1e3 if spans else None
