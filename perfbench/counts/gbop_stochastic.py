"""Operations and compulsory bytes of one stochastic GBOP plan of ``trees``
graphs, as functions of its shapes: ``actions`` A, next-state slots W,
``episodes`` E, ``horizon`` H, the observation's length ``obs`` and the
sweeps counted an episode. Each count is a lower bound, so a share of the
peak from it never reads too high.

A step of a graph (E x H a plan) hashes two observations, the step's node
and its next state (the quantisation and the position's product an
element: 2; murmur3's avalanche: 8), finds each in its table (the key's
slot and one test: 2), scores the node's A actions (each action's W atoms:
the child's two value bounds gathered, the two fused ``mu + gamma v``, the
empirical mass, the two products and sums of the expectation: 8 an atom;
an action's visited test for both bounds: 2), picks the optimistic action
(the tie test, the draw's selection and the argmax step: 3 an action),
steps the sailing boat (the move, the clip, the tack angle, the cost, the
goal test, the reward, the wind's two tests and turn: 12), looks the next
state's key up in the action's slots (2 a slot) and updates the statistics
(visited, the node's and the action's count, the slot's key, child, count
and sum: 8). The step's reward KL bounds are one paired launch
(``counts/kl_pair.py``, one entry a graph).

After each episode the sweeps of the value iteration: one pass over every
(node, action, slot) entry of the arena (8 an atom, 2 an action, as above)
and, per node, the largest bound over the actions and its change (2 each
for both bounds: 8). Only the first sweep of each episode is compulsory
(every graph's residual starts unbounded); the others depend on the data,
so the plan is counted with ``sweeps`` an episode.

Bytes: the draws read once (the tie breaks ``E x H x A`` and the root's
``A`` float32, the env's ``E x H`` uniforms), every arena field written once
(a node: its table slots, 2 x 16; visited, 1; its value bounds and count,
16; its A actions' counts and slot counts, 16 A; their W slots' count, key
and child as int64 and sum and two reward bounds as float32, 36 A W; its
state, the position and wind and step as int64, 32), each sweep's read of
the entries (count, child, two reward bounds: 24 an atom; the actions'
counts, 8 an action) and of the nodes' visited flags and bounds, and its
write of the bounds (1 + 16 a node), the graph's start state and
observation (32 + 4 obs) and its action (8).
"""
from __future__ import annotations

from perfbench.counts import kl_pair

HASH_OPS_PER_ELEMENT = 2
AVALANCHE_OPS = 8
LOOKUP_OPS = 2
ATOM_OPS = 8
ACTION_OPS = 2
CHOICE_OPS = 3
SAILING_OPS = 12
SLOT_OPS = 2
UPDATE_OPS = 8
NODE_SWEEP_OPS = 8

TABLE_BYTES_PER_NODE = 2 * 16
NODE_BYTES = 1 + 16
ACTION_BYTES = 16
ATOM_BYTES = 36
STATE_BYTES = 32
SWEEP_ATOM_BYTES = 24
SWEEP_ACTION_BYTES = 8
SWEEP_NODE_BYTES = 1 + 16


def arena_nodes(episodes: int, horizon: int) -> int:
    return 2 + episodes * horizon


def step_ops(actions: int, width: int, obs: int) -> int:
    hashing = 2 * (HASH_OPS_PER_ELEMENT * obs + AVALANCHE_OPS + LOOKUP_OPS)
    scoring = actions * (ATOM_OPS * width + ACTION_OPS + CHOICE_OPS)
    return hashing + scoring + SAILING_OPS + SLOT_OPS * width + UPDATE_OPS


def sweep_ops(nodes: int, actions: int, width: int) -> int:
    return nodes * (actions * (ATOM_OPS * width + ACTION_OPS) + NODE_SWEEP_OPS)


def sweep_bytes(nodes: int, actions: int, width: int) -> int:
    return nodes * (actions * (SWEEP_ATOM_BYTES * width + SWEEP_ACTION_BYTES) + SWEEP_NODE_BYTES)


def plan_ops(trees: int, actions: int, width: int, episodes: int, horizon: int, obs: int,
             sweeps: int) -> int:
    nodes = arena_nodes(episodes, horizon)
    per_graph = episodes * (horizon * step_ops(actions, width, obs)
                            + sweeps * sweep_ops(nodes, actions, width))
    return trees * per_graph + episodes * horizon * kl_pair.launch_ops(trees)


def plan_bytes(trees: int, actions: int, width: int, episodes: int, horizon: int, obs: int,
               sweeps: int) -> int:
    nodes = arena_nodes(episodes, horizon)
    draws = (episodes * horizon * (actions + 1) + actions) * 4
    arena = nodes * (TABLE_BYTES_PER_NODE + NODE_BYTES + STATE_BYTES
                     + actions * (ACTION_BYTES + ATOM_BYTES * width))
    swept = episodes * sweeps * sweep_bytes(nodes, actions, width)
    return trees * (draws + arena + swept + STATE_BYTES + 4 * obs + 8)
