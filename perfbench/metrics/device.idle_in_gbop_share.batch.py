"""The share of the device's idle time in the spanned pass's profiled plan
during which the host was inside one of the stochastic GBOP planner's own
spans (``gbop.episode`` around a replayed episode; ``gbop.descend``,
``gbop.bounds`` and ``gbop.vi`` where an episode runs eagerly;
``gbop.root``): idle time put down to the innermost span open at each
instant. None where the program records no such span."""
from perfbench.pbcore.spans import idle_share_under, program


def read(record):
    made = program(record)
    if made is None or not any(s.name.startswith("gbop.") for s in made["segment"].spans):
        return None
    return idle_share_under(record, "gbop.")
