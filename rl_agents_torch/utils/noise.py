"""Random inputs of the planners and the stochastic envs.

Every random choice of the port is an argmax or a comparison over noise that
the caller may inject, so that a test can replay the JAX package's own draws;
without injected noise it is drawn here from a ``torch.Generator``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _generator_device(generator: torch.Generator | None) -> torch.device:
    if generator is None:
        raise ValueError("a random draw needs a generator or injected noise")
    return generator.device


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform noise in [0, 1) of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device."""
    return torch.rand(shape, generator=generator, device=_generator_device(generator)).to(device)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` on ``device``, drawn from
    ``generator`` on the generator's own device."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=_generator_device(generator)).clamp(min=tiny)
    return (-torch.log(-torch.log(u))).to(device)


def noise_tensor(noise, device) -> torch.Tensor:
    """Injected noise (a tensor or an array-like, possibly read-only) as a
    float32 tensor on ``device``."""
    if not isinstance(noise, torch.Tensor):
        noise = torch.tensor(np.asarray(noise, dtype=np.float32))
    return noise.to(device=device, dtype=torch.float32)


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters ``x0, x1`` (uint32 arrays)
    under ``key`` (two uint32), as JAX's PRNG computes it."""
    def rotl(v, d):
        return (v << np.uint32(d)) | (v >> np.uint32(32 - d))

    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


@functools.lru_cache(maxsize=64)
def threefry_gumbel(key, size: int) -> np.ndarray:
    """``jax.random.gumbel(key, (size,), float32)`` on the host, for a raw
    threefry key (two uint32) under JAX's partitionable threefry (the default
    since JAX 0.5): element i takes the bits of the counter ``(0, i)``, so a
    shorter draw is a prefix of a longer one."""
    with np.errstate(over="ignore"):
        lo = np.arange(size, dtype=np.uint32)
        b0, b1 = _threefry2x32(key, np.zeros(size, np.uint32), lo)
    bits = b0 ^ b1
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(tiny, floats * (np.float32(1) - tiny) + tiny).astype(np.float32)
    draw = -np.log(-np.log(u))
    draw.flags.writeable = False
    return draw


# the key that the JAX package's deterministic planners step an env with
NULL_KEY = (0, 0)
