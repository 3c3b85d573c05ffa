"""Operations and compulsory bytes of one MCTS plan of ``trees`` trees, as
functions of its shapes.

An episode takes ``horizon`` steps of one transition each (descent or
rollout). A step of a tree scores its node's ``actions`` children by UCT (the
gathered value and count, the count plus one, the quotient and the sum: 4 a
child) and picks among them (the maximum, the tie test, the draw's selection
and the argmax step: 4 a child), draws the rollout action (a sum and an
argmax step a child: 2), and masks what the step changes: the choice between
the two actions (1), the expansion's test and write (2), the return's
product, selection and sum (3), the terminal flag (2), the node's move (2),
and one selection a value of the scene (``5 vehicles + 3``). Each episode
backs its return up ``horizon + 1`` nodes (the count's sum, the difference,
the quotient and the sum: 4 a node). The plan's descent compares
``actions`` counts and values a step (4 each).

Bytes: every transition's scene in and out (``counts/highway.py``), the
draws read once (``episodes x horizon x 2 x actions`` float32 a tree), and
every node's arena fields written once (parent, count: int64; children:
``actions`` int64; value and prior: float32), with the tree's node count,
plan and length (int64).
"""
from __future__ import annotations

from perfbench.counts import highway

CHILD_OPS = 10
STEP_OPS = 10
NODE_BACKUP_OPS = 4
PLAN_CHILD_OPS = 4


def scene_values(vehicles: int) -> int:
    """The values of one scene: x, lane, target lane, speed and alive a
    vehicle; speed level, crashed and step count."""
    return 5 * vehicles + 3


def plan_ops(trees: int, vehicles: int, actions: int, episodes: int, horizon: int) -> int:
    rows = trees * episodes * horizon
    step = CHILD_OPS * actions + STEP_OPS + scene_values(vehicles)
    per_tree = episodes * (horizon * step + NODE_BACKUP_OPS * (horizon + 1)) \
        + horizon * PLAN_CHILD_OPS * actions
    return highway.transition_ops(rows, vehicles) + trees * per_tree


def plan_bytes(trees: int, vehicles: int, actions: int, episodes: int, horizon: int) -> int:
    rows = trees * episodes * horizon
    nodes = 1 + episodes * actions
    node_fields = 2 * 8 + 8 * actions + 2 * 4
    draws = episodes * horizon * 2 * actions * 4
    return highway.transition_bytes(rows, vehicles) \
        + trees * (draws + nodes * node_fields + 8 + 8 * horizon + 8)
