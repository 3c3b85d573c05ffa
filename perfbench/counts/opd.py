"""Operations and compulsory bytes of one OPD plan of ``trees`` trees, as
functions of its shapes.

A round expands one leaf of every tree: ``actions`` transitions, the
selection of the leaf among ``N = 1 + expansions * actions`` nodes (a
select and an argmax step a node: 2 N), and each child's two bounds (5).
The consolidation reads every child link once (a max of each bound and a
count sum: 3 a link) at least once. The plan's descent compares ``actions``
values a step (3 each).

Bytes: every transition's scene in and out (``counts/highway.py``), and
every node's arena fields written once (parent, action, depth, count: int64;
children: ``actions`` int64; reward and the two bounds: float32; done and
leaf: bool).
"""
from __future__ import annotations

from perfbench.counts import highway


def plan_ops(trees: int, vehicles: int, actions: int, expansions: int, plan_capacity: int) -> int:
    nodes = 1 + expansions * actions
    rows = trees * expansions * actions
    per_tree = expansions * (2 * nodes + 5 * actions) + 3 * nodes * actions \
        + 3 * actions * plan_capacity
    return highway.transition_ops(rows, vehicles) + trees * per_tree


def plan_bytes(trees: int, vehicles: int, actions: int, expansions: int) -> int:
    nodes = 1 + expansions * actions
    rows = trees * expansions * actions
    node_fields = 4 * 8 + 8 * actions + 3 * 4 + 2
    return highway.transition_bytes(rows, vehicles) + trees * nodes * node_fields
