"""Random inputs of the planners and the stochastic envs.

Every random choice of the port is an argmax or a comparison over noise that
the caller may inject, so that a test can replay the JAX package's own draws;
without injected noise it is drawn here from a ``torch.Generator``.
"""
from __future__ import annotations

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
