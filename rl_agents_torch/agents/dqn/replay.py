"""Replay memory as a preallocated device ring.

Port of ``rl_agents_tpu/agents/dqn/replay.py`` (reference:
rl_agents/agents/common/memory.py:6-86), n-step collapse included
(memory.py:37-77). The ring lives on the agent's device; ``sample`` takes
injected indices or draws them from the agent's ``torch.Generator``. The
fused actor-learner (``parallel/actor_learner.py``) uses the same layout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device


class Batch(NamedTuple):
    state: torch.Tensor
    action: torch.Tensor      # i64
    reward: torch.Tensor      # f32
    next_state: torch.Tensor
    terminal: torch.Tensor    # bool


def empty_batch(capacity: int, obs_shape, device, obs_dtype=torch.float32) -> Batch:
    shape = (int(capacity),) + tuple(obs_shape)
    return Batch(state=torch.zeros(shape, dtype=obs_dtype, device=device),
                 action=torch.zeros(capacity, dtype=torch.int64, device=device),
                 reward=torch.zeros(capacity, dtype=torch.float32, device=device),
                 next_state=torch.zeros(shape, dtype=obs_dtype, device=device),
                 terminal=torch.zeros(capacity, dtype=torch.bool, device=device))


def discounts(gamma: float, n_steps: int, device) -> torch.Tensor:
    """``gamma ** i`` for i < n_steps, float32, from a host table of scalar
    float32 powers (XLA's ``pow`` rounds as they do)."""
    g32 = np.float32(gamma)
    return torch.tensor([g32 ** np.float32(i) for i in range(n_steps)], dtype=torch.float32,
                        device=device)


def n_step_collapse(data: Batch, start, size, n_steps: int, gamma: float,
                    stride: int = 1, discount: torch.Tensor | None = None) -> Batch:
    """Collapse n consecutive same-trajectory transitions starting at each
    ``start`` index into <s0, a0, sum(gamma^i r_i), s_n, done_n>, stopping at
    terminals (reference: memory.py:58-77). ``stride`` is the ring distance
    between consecutive same-env transitions: 1 for the object-path replay,
    ``num_envs`` for the fused actor-learner's interleaved ring. ``size`` may
    be an int or a device scalar; ``discount`` the table of ``discounts``,
    made here when not given."""
    batch_size = start.shape[0]
    device = start.device
    offsets = torch.arange(n_steps, device=device) * stride
    idx = torch.minimum(start[:, None] + offsets[None, :],
                        torch.as_tensor(size, device=device) - 1)  # [B, n]
    rewards = data.reward[idx]
    terminals = data.terminal[idx]
    # alive[b, i]: transition i contributes (no terminal strictly before it)
    prior = torch.nn.functional.pad(terminals[:, :-1].to(torch.int64), (1, 0))
    alive = ~(torch.cumsum(prior, dim=1) > 0)
    if discount is None:
        discount = discounts(gamma, n_steps, device)
    cum_reward = torch.sum(rewards * discount[None, :] * alive, dim=1)
    last = torch.clamp(alive.sum(dim=1) - 1, min=0)
    last_idx = idx[torch.arange(batch_size, device=device), last]
    return Batch(state=data.state[start], action=data.action[start], reward=cum_reward,
                 next_state=data.next_state[last_idx], terminal=data.terminal[last_idx])


class ReplayMemory:
    def __init__(self, capacity: int, obs_shape, n_steps: int = 1, gamma: float = 0.99,
                 device="cuda", generator: torch.Generator | None = None,
                 obs_dtype=torch.float32):
        self.capacity = int(capacity)
        self.n_steps = n_steps
        self.gamma = gamma
        self.device = resolve_device(device)
        self.generator = generator
        self.position = 0
        self.size = 0
        self.data = empty_batch(self.capacity, obs_shape, self.device, obs_dtype)

    def push(self, state, action, reward, next_state, terminal, info=None):
        dtype = self.data.state.dtype
        pos = self.position
        self.data.state[pos] = torch.tensor(np.asarray(state), dtype=dtype, device=self.device)
        self.data.action[pos] = int(action)
        self.data.reward[pos] = float(reward)
        self.data.next_state[pos] = torch.tensor(np.asarray(next_state), dtype=dtype,
                                                 device=self.device)
        self.data.terminal[pos] = bool(terminal)
        self.position = (self.position + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int, indices=None) -> Batch:
        """A minibatch at ``indices`` (``[batch_size]``, each below ``len(self)``),
        or at indices drawn uniformly from the generator."""
        if indices is None:
            indices = torch.randint(0, self.size, (batch_size,), generator=self.generator,
                                    device=self.device)
        else:
            indices = torch.tensor(np.asarray(indices), dtype=torch.int64, device=self.device)
        if self.n_steps == 1:
            return Batch(*(x[indices] for x in self.data))
        return n_step_collapse(self.data, indices, self.size, self.n_steps, self.gamma)

    def __len__(self):
        return self.size

    def is_full(self):
        return self.size == self.capacity

    def is_empty(self):
        return self.size == 0

    def state_dict(self):
        return {"data": {k: v.cpu() for k, v in self.data._asdict().items()},
                "position": self.position, "size": self.size}

    def load_state_dict(self, d):
        self.data = Batch(**{k: v.to(self.device) for k, v in d["data"].items()})
        self.position = d["position"]
        self.size = d["size"]
