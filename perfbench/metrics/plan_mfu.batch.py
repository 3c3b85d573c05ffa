"""The whole plan's share of the chip's peak: the plan's counted operations
and compulsory bytes (``counts/``, functions of the cell's shapes), the
larger of operations over peak float32 rate and bytes over peak bandwidth,
over the mean wall time of the window's plans."""
from statistics import fmean


def read(record):
    plan, peaks = record.get("plan"), record.get("peaks")
    if not plan or not peaks or not plan.get("seconds"):
        return None
    least = max(plan["ops"] / peaks["f32_ops_per_s"], plan["bytes"] / peaks["bytes_per_s"])
    return 100.0 * least / fmean(plan["seconds"])
