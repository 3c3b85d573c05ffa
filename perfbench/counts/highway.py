"""Operations and compulsory bytes of highway transitions, as functions of
their shapes.

Operations are float32 arithmetic, comparisons, selections and reduction
steps on the scene's values, tallied from the algorithm of
``reference/highway.py`` (not from the program's kernels):

- per ordered pair of vehicles, per neighbour query: two differences, an
  absolute value, a lane test, an order test, the gap's minimum, the tie
  test and the speed sum: 8; six queries (ahead and behind, in the current
  lane and the two candidate lanes): 48; the lane-change conflict test: 5;
  the collision test: 6. 59 in all.
- per vehicle: nine IDM evaluations of 20 each (the desired gap's fused
  product and quotient, the ratio's clamps and quotient, the free-road and
  interaction terms, the clamp to [-b, a]): 180; MOBIL's gains, safety and
  choice for two candidate lanes: 30; speed, position and lane updates: 10.
  220 in all.
- per scene: the ego's speed level and target, and the reward: 10.

Bytes count each input read once and each output written once: a scene of
V vehicles is x, lane, speed (float32), target lane (int64) and alive (bool)
per vehicle, and speed level, step count (int64) and crashed (bool) per
scene: 21 V + 17 bytes; an action is 8 bytes and a reward 4.
"""
from __future__ import annotations

PAIR_OPS = 59
VEHICLE_OPS = 220
SCENE_OPS = 10


def scene_bytes(vehicles: int) -> int:
    return 21 * vehicles + 17


def transition_ops(rows: int, vehicles: int) -> int:
    return rows * (PAIR_OPS * vehicles * vehicles + VEHICLE_OPS * vehicles + SCENE_OPS)


def transition_bytes(rows: int, vehicles: int) -> int:
    """A scene and an action read, the next scene and a reward written."""
    return rows * (2 * scene_bytes(vehicles) + 8 + 4)
