"""Observation hashing and open-addressing node tables, batch-first.

Port of ``rl_agents_tpu/ops/hashing.py``. Observations are quantised and
mixed into 32-bit keys, and a linear-probing hash table in tensors maps keys
to node slots. Every function takes a leading batch axis: one key, one table
row and one insert per tree.

PyTorch's uint32 support is partial, so keys are int64 tensors holding values
in ``[0, 2^32)`` and every product is reduced modulo 2^32 in int64 arithmetic
that never overflows.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device

_MASK32 = 0xFFFFFFFF
_MIX_PRIME = 2654435761  # Knuth multiplicative hashing
_EMPTY = 0


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 operands in ``[0, 2^32)``: the product
    would overflow int64, so ``b`` is taken in two 16-bit halves."""
    low = a * (b & 0xFFFF)
    high = ((a * (b >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK32


def obs_key(obs, precision: float = 1e-4) -> torch.Tensor:
    """Hash a batch of observations to 32-bit keys ``[B]`` (0 is reserved).

    ``obs`` is a tensor ``[B, ...]`` or a tuple or list of such tensors; each
    row is flattened. Multiply-sum universal hashing and a murmur3 avalanche,
    as in the JAX package, which computes in uint32: the float is rounded half
    to even, cast to int32 (saturating) and reinterpreted as unsigned."""
    leaves = obs if isinstance(obs, (tuple, list)) else (obs,)
    flat = torch.cat([x.reshape(x.shape[0], -1).to(torch.float32) for x in leaves], dim=1)
    # ``flat / precision`` in the JAX package: XLA multiplies by the float32
    # reciprocal of the constant (so does PyTorch's CUDA division by a scalar)
    scale = float(np.float32(1) / np.float32(precision))
    q = torch.round(flat * scale).to(torch.float64)
    q = torch.nan_to_num(q, nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64) & _MASK32
    n = q.shape[1]
    # fixed odd position multipliers (Weyl sequence): sum_i q_i * c_i mod 2^32
    c = _mul32(torch.arange(1, n + 1, device=q.device), _MIX_PRIME) | 1
    h = _mul32(q, c).sum(dim=1) & _MASK32
    # murmur3 fmix32 avalanche
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return torch.clamp(h, min=1)  # avoid the empty sentinel


class HashTable(NamedTuple):
    keys: Any    # [B, T] i64 holding 32-bit keys, 0 = empty
    values: Any  # [B, T] i64 node ids
    count: Any   # [B] i64 number of entries


def table_init(capacity: int, batch: int = 1, device="cuda") -> HashTable:
    """capacity should be ~2x the expected entries (power of two)."""
    device = resolve_device(device)
    return HashTable(keys=torch.zeros((batch, capacity), dtype=torch.int64, device=device),
                     values=torch.full((batch, capacity), -1, dtype=torch.int64, device=device),
                     count=torch.zeros((batch,), dtype=torch.int64, device=device))


def _probe_slot(table: HashTable, key):
    """Per row, the first slot in linear-probe order holding ``key`` or empty:
    probe rank per slot and one min, no loop."""
    T = table.keys.shape[1]
    start = key % T
    rank = (torch.arange(T, device=key.device) - start[:, None]) % T  # probe order position
    candidate = (table.keys == key[:, None]) | (table.keys == _EMPTY)
    first_rank = torch.where(candidate, rank, T).amin(dim=1)
    slot = (start + first_rank) % T
    found = first_rank < T  # False only when the row is full of other keys
    slot_key = table.keys.gather(1, slot[:, None]).squeeze(1)
    return slot, slot_key, found


def table_lookup_or_insert(table: HashTable, key, new_value):
    """Find ``key [B]`` in each row; insert it with ``new_value [B]`` where
    absent. Returns ``(table, value, is_new)``, a new table: the argument is
    not written. Where a row is full and its key absent: ``(-1, False)``."""
    slot, slot_key, found = _probe_slot(table, key)
    exists = found & (slot_key == key)
    can_insert = found & (slot_key == _EMPTY)
    at = slot[:, None]
    existing = table.values.gather(1, at).squeeze(1)
    keys = table.keys.scatter(1, at, torch.where(can_insert, key, slot_key)[:, None])
    values = table.values.scatter(1, at, torch.where(can_insert, new_value, existing)[:, None])
    value = torch.where(exists, existing, torch.where(can_insert, new_value, -1))
    return HashTable(keys, values, table.count + can_insert), value, can_insert


def table_lookup(table: HashTable, key) -> torch.Tensor:
    """Find ``key [B]`` in each row; -1 where absent."""
    slot, slot_key, found = _probe_slot(table, key)
    existing = table.values.gather(1, slot[:, None]).squeeze(1)
    return torch.where(found & (slot_key == key), existing, -1)
