"""The device's idle share of the traced agent steps: 1 - the union of the
kernel intervals over the traced window."""
from perfbench.pbcore.profiling import idle_percent


def read(record):
    return idle_percent(record.get("segments", []))
