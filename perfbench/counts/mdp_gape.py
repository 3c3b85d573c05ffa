"""Operations and compulsory bytes of one MDP-GapE plan of ``trees`` trees,
as functions of its shapes: ``actions`` A, next-state slots W, the MDP's
branching K, ``episodes`` E (a plan runs E + 1) and ``horizon`` H. Each
count is a lower bound, so a share of the peak from it never reads too high.

A step of a tree (E + 1 episodes of H) scores its node's A chance children
(the gathered upper bound, the maximum, the tie test, the draw's selection
and the argmax step: 5 a child), steps the garnet (the categorical draw's
logarithm, sum and argmax step a branch: 3 a branch; the gathers of the
next state and reward, the two done tests: 4), hashes the next state (the
quantisation, the product and murmur3's six steps: 8), looks it up in the
chance node's slots (the key test and the filled test a slot: 2 a slot) and
updates the statistics (count, sum, done, the chance count and the slot's
insert: 6).

An episode then solves the KL bounds of its H path nodes
(``counts/kl_pair.py``), backs up H decision nodes (the largest upper and
lower bound over A chance children: 2 a child) and H chance nodes (two
constrained problems over W atoms, each its empirical distribution, the
fused ``mu + gamma v`` and the zero-mass case: 6 an atom; one Newton trip,
the function and its slope: 8 an atom; the optimum's distribution and its
expectation: 5 an atom), and scores the root's A arms for UGapE (the
largest other bound, the gap, the argmin and argmax steps: 4 an arm).

Bytes: the draws read once (``(E + 1) x H x (A + K)`` float32 a tree), every
arena field written once (a decision node: parent, depth, count, A children
as int64, the reward sum, two KL bounds and two value bounds as float32,
the done flag: ``8 (3 + A) + 20 + 1``; a chance node: parent, depth, count,
slot count, W keys and W children as int64, two value bounds as float32:
``8 (4 + 2 W) + 8``), the tree's start state, node counts, best action and
episodes (8 each).
"""
from __future__ import annotations

from perfbench.counts import kl_pair

CHILD_OPS = 5
BRANCH_OPS = 3
TRANSITION_OPS = 4
HASH_OPS = 8
SLOT_OPS = 2
UPDATE_OPS = 6
DECISION_CHILD_OPS = 2
ATOM_OPS = 6 + 8 + 5
PROBLEMS = 2
ARM_OPS = 4


def arena_nodes(episodes: int, horizon: int, actions: int) -> tuple:
    decision = 1 + (episodes + 1) * horizon
    return decision, 1 + decision * actions


def plan_ops(trees: int, actions: int, width: int, branching: int, episodes: int,
             horizon: int) -> int:
    step = CHILD_OPS * actions + BRANCH_OPS * branching + TRANSITION_OPS + HASH_OPS \
        + SLOT_OPS * width + UPDATE_OPS
    episode = horizon * (step + DECISION_CHILD_OPS * actions + PROBLEMS * ATOM_OPS * width) \
        + ARM_OPS * actions
    runs = episodes + 1
    return trees * runs * episode + runs * kl_pair.launch_ops(horizon * trees)


def plan_bytes(trees: int, actions: int, width: int, branching: int, episodes: int,
               horizon: int) -> int:
    decision, chance = arena_nodes(episodes, horizon, actions)
    draws = (episodes + 1) * horizon * (actions + branching) * 4
    arena = decision * (8 * (3 + actions) + 20 + 1) + chance * (8 * (4 + 2 * width) + 8)
    return trees * (draws + arena + 4 * 8)
