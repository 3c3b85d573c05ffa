"""Seeding helpers.

Port of ``rl_agents_tpu/utils/seeding.py`` (reference:
agents/common/seeding.py:18-35): ``np_random(seed)`` returns a numpy
Generator backed by PCG64 seeded through a SeedSequence, as gymnasium's
seeding does, so host-side random streams match the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def np_random(seed: Optional[int] = None) -> Tuple[np.random.Generator, int]:
    """(reference: seeding.py:18-35; gymnasium.utils.seeding.np_random)"""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"Seed must be a non-negative integer or omitted, not {seed}")
    seed_seq = np.random.SeedSequence(seed)
    seed = seed_seq.entropy
    rng = np.random.Generator(np.random.PCG64(seed_seq))
    return rng, seed
