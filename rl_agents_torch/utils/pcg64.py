"""numpy's PCG64 bit generator as tensor functions.

Port of ``rl_agents_tpu/utils/pcg64.py``. The reference planners break ties
with gymnasium's ``np_random`` = ``np.random.Generator(np.random.PCG64(seed))``
(reference: agents/common/seeding.py:18-35, tree_search/abstract.py:295-311);
the parity planners replay those draws on the device, so this module
reproduces numpy bit for bit:

- the 128-bit LCG state is kept as 8 little-endian 16-bit digits in an
  ``int64`` tensor (torch has no complete unsigned 32/64-bit arithmetic, and
  none on CUDA): every partial product of two digits fits in 32 bits, and a
  column sum of eight of them in 35;
- the XSL-RR output function gives a 64-bit draw as two 32-bit words
  ``(hi, lo)``, each an ``int64`` in ``[0, 2^32)``;
- ``pcg64_next32`` keeps numpy's persistent 32-bit buffer, and
  ``pcg64_integers`` is numpy's buffered 32-bit Lemire rejection sampler
  (what ``Generator.integers`` and ``Generator.choice(n)`` consume);
- ``pcg64_double`` is ``Generator.random()``;
- seeding takes ``np.random.PCG64(seed).state`` on the host, so numpy's
  SeedSequence expansion is reused.

Every function works on any leading batch shape: the digits are ``[..., 8]``
and the buffer, its flag, the bound and the results ``[...]``. Lanes draw
independently; a lane that draws nothing keeps its stream unchanged.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device

# PCG64's default 128-bit multiplier
_PCG_MULT = 0x2360ED051FC65DA44385DF649FCCF645
_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF


def int_to_digits(x: int) -> np.ndarray:
    """A 128-bit integer as 8 little-endian 16-bit digits."""
    return np.array([(x >> (16 * i)) & _MASK16 for i in range(8)], np.int64)


def digits_to_int(d) -> int:
    """8 little-endian 16-bit digits as one integer."""
    d = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    return sum(int(v) << (16 * i) for i, v in enumerate(d))


class PCG64Stream(NamedTuple):
    """numpy's ``pcg64_state``: the 128-bit LCG state as 16-bit digits plus
    the 32-bit draw buffer (``uinteger``/``has_uint32``) that persists across
    ``Generator.integers`` calls."""

    digits: Any    # [..., 8] i64, 16-bit little-endian digits
    buf: Any       # [...] i64, the buffered high word
    has_buf: Any   # [...] bool


def pcg64_init(seed: int | Sequence[int], device="cuda"):
    """``(stream, inc)`` equal to ``np.random.PCG64(seed).state``. A sequence
    of seeds gives a leading batch axis, one stream per seed."""
    device = resolve_device(device)
    seeds = [seed] if np.ndim(seed) == 0 else list(seed)
    states = [np.random.PCG64(int(s)).state for s in seeds]
    digits = np.stack([int_to_digits(s["state"]["state"]) for s in states])
    inc = np.stack([int_to_digits(s["state"]["inc"]) for s in states])
    buf = np.array([s["uinteger"] for s in states], np.int64)
    has_buf = np.array([bool(s["has_uint32"]) for s in states])
    if np.ndim(seed) == 0:
        digits, inc, buf, has_buf = digits[0], inc[0], buf[0], has_buf[0]
    stream = PCG64Stream(digits=torch.tensor(digits, device=device),
                         buf=torch.tensor(buf, device=device),
                         has_buf=torch.tensor(has_buf, device=device))
    return stream, torch.tensor(inc, device=device)


def stream_where(mask, new: PCG64Stream, old: PCG64Stream) -> PCG64Stream:
    """Per-lane select between two streams of the same batch shape."""
    return PCG64Stream(digits=torch.where(mask[..., None], new.digits, old.digits),
                       buf=torch.where(mask, new.buf, old.buf),
                       has_buf=torch.where(mask, new.has_buf, old.has_buf))


def _mul_add_128(a, b, c):
    """``(a * b + c) mod 2^128`` on digit tensors ``[..., 8]``: column sums
    of the digit products, then one carry pass."""
    cols = c.clone()
    for i in range(8):
        cols[..., i:] += a[..., i:i + 1] * b[..., :8 - i]
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[..., 0])
    for k in range(8):
        t = cols[..., k] + carry
        out[..., k] = t & _MASK16
        carry = t >> 16
    return out


_MULT = {}


def _mult_digits(device):
    if device not in _MULT:
        _MULT[device] = torch.tensor(int_to_digits(_PCG_MULT), device=device)
    return _MULT[device]


def _raw64(digits, inc):
    """One PCG64 draw from bare digits: step the LCG, then XSL-RR. Returns
    ``(new_digits, (hi, lo))``, the draw being ``hi * 2^32 + lo``."""
    d = _mul_add_128(_mult_digits(digits.device).expand_as(digits), digits, inc)
    lo_lo = d[..., 0] | (d[..., 1] << 16)
    lo_hi = d[..., 2] | (d[..., 3] << 16)
    hi_lo = d[..., 4] | (d[..., 5] << 16)
    hi_hi = d[..., 6] | (d[..., 7] << 16)
    x_lo = lo_lo ^ hi_lo
    x_hi = lo_hi ^ hi_hi
    rot = (d[..., 7] >> 10) & 0x3F  # state >> 122: the top 6 bits
    # rotate the 64-bit word (x_hi, x_lo) right by rot
    r = rot & 31
    swap = rot >= 32
    a_hi = torch.where(swap, x_lo, x_hi)
    a_lo = torch.where(swap, x_hi, x_lo)
    inv = (32 - r) & 31
    spill = r != 0  # a shift by 32 - 0 would keep the whole word
    out_lo = (a_lo >> r) | torch.where(spill, (a_hi << inv) & _MASK32, 0)
    out_hi = (a_hi >> r) | torch.where(spill, (a_lo << inv) & _MASK32, 0)
    return d, (out_hi, out_lo)


def pcg64_next64(stream: PCG64Stream, inc):
    """``next_uint64``: a raw 64-bit draw ``(hi, lo)``. The 32-bit buffer is
    left as it is (numpy's pcg64_next64 bypasses it too)."""
    digits, out = _raw64(stream.digits, inc)
    return stream._replace(digits=digits), out


def pcg64_next32(stream: PCG64Stream, inc):
    """``next_uint32`` with numpy's buffering (pcg64.h pcg64_next32): the
    buffered high word if there is one, else the low word of a fresh 64-bit
    draw, whose high word is buffered."""
    digits, (hi, lo) = _raw64(stream.digits, inc)
    use_buf = stream.has_buf
    x = torch.where(use_buf, stream.buf, lo)
    new = PCG64Stream(digits=torch.where(use_buf[..., None], stream.digits, digits),
                      buf=torch.where(use_buf, stream.buf, hi),
                      has_buf=~use_buf)
    return new, x


def _mul_32_32(x, n):
    """``x * n`` for ``x, n`` in ``[0, 2^32)`` as ``(hi32, lo32)``, in int64
    without overflow: ``x`` is taken in two 16-bit halves."""
    t = (x & _MASK16) * n          # < 2^48
    u = (x >> 16) * n              # < 2^48
    low = t + ((u & _MASK16) << 16)  # < 2^49
    return (low >> 32) + (u >> 16), low & _MASK32


def pcg64_integers(stream: PCG64Stream, inc, n, mask=None):
    """numpy ``Generator.integers(0, n)`` for ``n <= 2^32 - 1``: buffered
    32-bit Lemire over ``pcg64_next32`` draws (numpy _bounded_integers.pyx,
    ``buffered_bounded_lemire_uint32``)::

        m = next32 * n;  reject while (uint32) m < (2^32 - n) % n;  result = m >> 32

    ``n <= 1`` draws nothing and gives 0 (numpy's ``rng == 0`` early out), as
    does a lane where ``mask`` is False. The rejection loop redraws the
    rejected lanes until none is left (one read-back per trip; a rejection
    has probability below ``n / 2^32``). Returns ``(new_stream, value)``."""
    n = torch.as_tensor(n, dtype=torch.int64, device=stream.buf.device).expand_as(stream.buf)
    draw = n > 1
    if mask is not None:
        draw = draw & mask
    safe_n = torch.clamp(n, min=1)
    threshold = ((_MASK32 % safe_n) + 1) % safe_n  # (2^32 - n) % n
    new, x = pcg64_next32(stream, inc)
    stream = stream_where(draw, new, stream)
    res, leftover = _mul_32_32(x, safe_n)
    pending = draw & (leftover < threshold)
    while bool(pending.any()):
        new, x = pcg64_next32(stream, inc)
        stream = stream_where(pending, new, stream)
        r2, l2 = _mul_32_32(x, safe_n)
        res = torch.where(pending, r2, res)
        leftover = torch.where(pending, l2, leftover)
        pending = pending & (leftover < threshold)
    return stream, torch.where(draw, res, 0)


def pcg64_choice(stream: PCG64Stream, inc, n, mask=None):
    """``Generator.choice(n)`` is ``integers(0, n)`` (numpy _generator.pyx,
    ``choice`` with ``replace=True, p=None``)."""
    return pcg64_integers(stream, inc, n, mask)


_TWO_POW_M53 = 1.0 / 9007199254740992.0


def pcg64_double(stream: PCG64Stream, inc, mask=None):
    """numpy ``Generator.random()``: the top 53 bits of one raw 64-bit draw
    times ``2^-53`` (distributions.c ``next_double``), as float64. Bypasses
    the 32-bit buffer as ``next_uint64`` does. A lane where ``mask`` is False
    keeps its stream."""
    new, (hi, lo) = pcg64_next64(stream, inc)
    if mask is not None:
        new = stream_where(mask, new, stream)
    # (hi * 2^32 + lo) >> 11 == hi * 2^21 + (lo >> 11), below 2^53: exact
    top = (hi << 21) + (lo >> 11)
    return new, top.to(torch.float64) * _TWO_POW_M53


class ParityStream:
    """Host-facing wrapper of one stream with the subset of
    ``np.random.Generator`` that the reference planners consume."""

    def __init__(self, seed: int, device="cuda"):
        self.stream, self.inc = pcg64_init(seed, device=device)

    def integers(self, n: int) -> int:
        self.stream, v = pcg64_integers(self.stream, self.inc, n)
        return int(v)

    def choice(self, items):
        items = list(items)
        return items[self.integers(len(items))]
