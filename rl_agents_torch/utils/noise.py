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


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as two uint32 (threefry): a 32-bit seed
    goes to the low word."""
    return (0, int(seed) & 0xFFFFFFFF)


def _threefry_counters(key, size: int):
    """The two words of threefry-2x32 under ``key`` at the counters
    ``(0, i)`` for i < size, as JAX's partitionable threefry takes them."""
    with np.errstate(over="ignore"):
        return _threefry2x32(key, np.zeros(size, np.uint32), np.arange(size, dtype=np.uint32))


def threefry_split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` for a raw threefry key."""
    b0, b1 = _threefry_counters(key, num)
    return [(int(x), int(y)) for x, y in zip(b0, b1)]


def threefry_bits(key, size: int) -> np.ndarray:
    """``jax.random.bits(key, (size,), uint32)``: element i is the xor of the
    two words at the counter ``(0, i)``."""
    b0, b1 = _threefry_counters(key, size)
    return b0 ^ b1


def threefry_randint(key, maxval: int, minval: int = 0) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` on the host (int32):
    two words of bits from the key's two halves, each reduced modulo the span
    and combined as JAX does to keep the draw nearly uniform."""
    k1, k2 = threefry_split(key, 2)
    higher, lower = int(threefry_bits(k1, 1)[0]), int(threefry_bits(k2, 1)[0])
    span = max(int(maxval) - int(minval), 1)
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier) % 2 ** 32 % span  # uint32 arithmetic wraps
    offset = ((higher % span) * multiplier % 2 ** 32 + lower % span) % 2 ** 32 % span
    return int(minval) + offset


def threefry_uniform(key, shape, low, high) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, low, high)`` on the host."""
    size = int(np.prod(shape, dtype=np.int64))
    bits = threefry_bits(key, size)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    low = np.broadcast_to(np.asarray(low, np.float32), shape).reshape(-1)
    high = np.broadcast_to(np.asarray(high, np.float32), shape).reshape(-1)
    # floats * (high - low) + low is one fused multiply-add in XLA
    scaled = (floats.astype(np.float64) * (high - low) + low).astype(np.float32)
    return np.maximum(low, scaled).reshape(shape)
