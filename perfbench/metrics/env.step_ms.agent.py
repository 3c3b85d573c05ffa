"""Mean milliseconds of the env handle's ``step`` over the traced run's
window: the transition and the observation of one scene (host clock around
each call, which ends by reading the reward on the host)."""
from statistics import fmean


def read(record):
    spans = record.get("spans", {}).get("env.step")
    return fmean(spans) * 1e3 if spans else None
