"""Operations and compulsory bytes of one KL-OLOP plan of ``trees`` trees,
as functions of its shapes.

An episode takes ``horizon`` steps of one transition each, choosing among
``actions`` B-values a step (2 each) and updating the child's sum and count
(2); then one KL launch over its path (``counts/kl.py``, at least one trip a
node) and the backup of ``horizon + 1`` nodes (a max over the children, one
fused product and sum: ``actions + 2``). The plan's descent compares
``actions`` counts and values a step (4 each).

Bytes: every transition's scene in and out (``counts/highway.py``), each
KL launch's bytes, and every node's arena fields written once (parent,
depth, count: int64; children: ``actions`` int64; sum, bound and B-value:
float32; done: bool).
"""
from __future__ import annotations

from perfbench.counts import highway, kl


def plan_ops(trees: int, vehicles: int, actions: int, episodes: int, horizon: int) -> int:
    rows = trees * episodes * horizon
    path_nodes = trees * horizon
    per_tree = episodes * (horizon * (2 * actions + 2) + (horizon + 1) * (actions + 2)) \
        + horizon * 4 * actions
    return highway.transition_ops(rows, vehicles) + trees * per_tree \
        + episodes * kl.launch_ops(path_nodes)


def plan_bytes(trees: int, vehicles: int, actions: int, episodes: int, horizon: int) -> int:
    nodes = 1 + episodes * horizon * actions
    rows = trees * episodes * horizon
    node_fields = 3 * 8 + 8 * actions + 3 * 4 + 1
    return highway.transition_bytes(rows, vehicles) + episodes * kl.launch_bytes(trees * horizon) \
        + trees * nodes * node_fields
