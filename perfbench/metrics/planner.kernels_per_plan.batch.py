"""Device kernels a whole plan launches, counted in the profiler's trace.
A segment that ran the whole plan gives it; otherwise two segments of fewer
episodes give the kernels an episode and those of the plan's fixed part,
and the whole plan's count follows (each episode launches the same
kernels)."""


def read(record):
    plans = [s for s in record.get("segments", []) if s.label == "plan" and s.kernels]
    for s in plans:
        if s.units == s.full_units:
            return float(len(s.kernels))
    if len(plans) < 2 or plans[0].units == plans[-1].units:
        return None
    a, b = plans[0], plans[-1]
    per_unit = (len(b.kernels) - len(a.kernels)) / (b.units - a.units)
    return float(len(a.kernels) + per_unit * (a.full_units - a.units))
