"""Every random input of a run, made from ``--seed``: a generator on the
run's device for each stream, seeded from the run's seed, the stream and an
index through numpy's ``SeedSequence`` (any seed up to 2**64 works)."""
from __future__ import annotations

import numpy as np
import torch

SCENES, PLAN, EPISODE, SAMPLE, WARMUP = range(5)


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    return int(np.random.SeedSequence([int(seed), stream, index]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, index))
    return gen


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device).clamp(min=tiny)
    return -torch.log(-torch.log(u))
