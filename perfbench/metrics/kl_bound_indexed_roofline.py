"""The ``kl_bound_indexed_`` launch's share of its roofline: the least time
the chip could take for the launch's compulsory bytes and operations
(``counts/kl.py``: 24 bytes a path node; at least one Newton trip a node),
the larger of bytes over peak bandwidth and operations over peak float32
rate, over the mean device time of the launches in the trace. It is bound
by bytes at these sizes."""
from statistics import fmean


def read(record):
    counts = record.get("kernels", {}).get("kl_bound_indexed")
    peaks = record.get("peaks")
    if not counts or not peaks:
        return None
    times = [end - start for s in record.get("segments", []) for name, start, end in s.kernels
             if "kl_bound_indexed" in name]
    if not times:
        return None
    least_us = max(counts["bytes"] / peaks["bytes_per_s"],
                   counts["ops"] / peaks["f32_ops_per_s"]) * 1e6
    return 100.0 * least_us / fmean(times)
