"""Operations and bytes of one ``kl_bound_indexed_`` launch: the KL upper
bounds of the ``path_nodes`` nodes of one OLOP episode (``horizon x trees``)
inside ``[trees, N]`` arenas.

Bytes: per node its sum (float32, 4), count (int64, 8) and index (int64, 8)
read, its bound (float32, 4) written: 24; and the threshold (4) once. This
is the compulsory traffic whatever the kernel reads again.

Operations: 4 to set up a node (mean, divergence budget, interval, start)
and 18 a Newton trip (the divergence with its two logarithms, its
derivative, the guarded step, the relaxation and the stop test), one trip
counted a node: every node takes at least one, so the count is a lower bound
and a share of the peak from it never reads too high.
"""
from __future__ import annotations

BYTES_PER_NODE = 24
THRESHOLD_BYTES = 4
OPS_PER_NODE = 4
OPS_PER_TRIP = 18


def launch_bytes(path_nodes: int) -> int:
    return BYTES_PER_NODE * path_nodes + THRESHOLD_BYTES


def launch_ops(path_nodes: int) -> int:
    return (OPS_PER_NODE + OPS_PER_TRIP) * path_nodes
