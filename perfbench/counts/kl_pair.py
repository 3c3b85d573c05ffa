"""Operations and bytes of one ``kl_bounds_pair_`` launch: the KL upper and
lower bounds of the ``path_nodes`` entries of one MDP-GapE episode's path
(``horizon x trees``) inside ``[trees, Nd]`` arenas, under a ``[trees]``
mask and a threshold table of ``table`` entries.

Bytes: per entry its sum (float32, 4), count (int64, 8) and offset (int64,
8) read, its two bounds (float32, 4 each) written: 28; the mask (1 a tree)
and the table (4 an entry) once. This is the compulsory traffic whatever
the kernel reads again.

Operations: each of the two bounds as ``counts/kl.py`` counts one, 4 to set
it up and one Newton trip of 18, a lower bound (every entry takes at least
one trip), so a share of the peak from it never reads too high.
"""
from __future__ import annotations

from perfbench.counts import kl

BYTES_PER_ENTRY = 28
MASK_BYTES_PER_TREE = 1
TABLE_BYTES_PER_ENTRY = 4
BOUNDS = 2


def launch_bytes(path_nodes: int, trees: int, table: int) -> int:
    return BYTES_PER_ENTRY * path_nodes + MASK_BYTES_PER_TREE * trees \
        + TABLE_BYTES_PER_ENTRY * table


def launch_ops(path_nodes: int) -> int:
    return BOUNDS * (kl.OPS_PER_NODE + kl.OPS_PER_TRIP) * path_nodes
