"""Math helpers: KL confidence bounds and constrained-KL optimisation.

Port of ``rl_agents_tpu/utils/math.py`` (reference: rl_agents/utils.py:43-366).
Where the JAX package writes a scalar function and vmaps it, these functions
take tensors with leading batch axes: elementwise ones broadcast, and those
over a distribution or a score vector work along the last axis. The batched
KL-UCB solve itself lives in ``rl_agents_torch/ops/kl_bound.py``;
``kl_upper_bound`` is its name here. Solvers that loop until convergence in
the JAX package run masked trips over the whole batch instead: bisection a
fixed number of them, the Newton solve in blocks with one read-back between
blocks.

``torch.where`` evaluates both branches, so the guarded logs below keep their
inner ``where``s: without them the kept branch would pick up ``nan``/``inf``
from ``log(0)`` through the arithmetic of the dropped one.
"""
from __future__ import annotations

import itertools
from typing import List

import numpy as np
import torch

NEWTON_MAX_ITERATIONS = 100
NEWTON_BLOCK = 8  # masked Newton trips between two reads of "is any element still active"
NEWTON_OOB_WEIGHT = 0.9  # out-of-bounds relaxation weight (reference utils.py:151)


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a float32 tensor, on ``like``'s device when it is not a tensor yet."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=None if like is None else like.device)


def constrain(x, a, b):
    x = _f32(x)
    return torch.minimum(torch.maximum(x, _f32(a, x)), _f32(b, x))


def not_zero(x, eps: float = 0.01):
    x = _f32(x)
    return torch.where(torch.abs(x) > eps, x, torch.where(x >= 0, eps, -eps))


def wrap_to_pi(x):
    return torch.remainder(_f32(x) + np.pi, 2 * np.pi) - np.pi


def remap(v, x, y, clip: bool = False):
    out = y[0] + (v - x[0]) * (y[1] - y[0]) / (x[1] - x[0])
    if clip:
        out = constrain(out, y[0], y[1])
    return out


def pos(x):
    return torch.clamp(_f32(x), min=0)


def neg(x):
    return torch.clamp(-_f32(x), min=0)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` on float32 tensors, rounded once, as a fused
    multiply-add: XLA compiles the JAX package's ``c + a * b`` to one on the
    CPU, and the planners compare such sums for exact ties, so one rounding
    step decides which branch a descent takes. The float64 product of two
    float32 values is exact. One ``addcmul`` in float64 (the other operands
    are promoted inside it) and one cast: two kernels on the card."""
    return torch.addcmul(c, a.double(), b).to(torch.float32)


def recip(c) -> float:
    """The float32 reciprocal of the float32 constant ``c``: XLA turns a
    division by a constant of the program into a multiplication by it, so
    the JAX package's ``x / c`` is ``x * recip(c)`` here."""
    return float(np.float32(1) / np.float32(c))


def fnma(a, b, c) -> torch.Tensor:
    """``c - a * b`` on float32 tensors, rounded once: ``fma(-a, b, c)``
    without the negation's kernel."""
    return torch.addcmul(c, a.double(), b, value=-1).to(torch.float32)


def matvec(m, x) -> torch.Tensor:
    """``m @ x`` for a small matrix ``m`` (``[..., p, q]``) and vectors ``x``
    (``[..., q]``), rounded as XLA's CPU dot rounds it: the first column's
    product, then one fused multiply-add per further column, in order. The
    linear envs and the interval predictor compare their states bit for bit
    with the JAX package's."""
    acc = m[..., 0] * x[..., 0, None]
    return matvec_add(acc, m[..., 1:], x[..., 1:])


def matvec_add(acc, m, x, sign: float = 1.0) -> torch.Tensor:
    """``acc + sign * (m @ x)`` as one fused multiply-add per column of ``m``,
    in order: XLA computes a product with one column (``B @ u`` with a
    single control) as a multiply, and fuses it into the sum it feeds."""
    for k in range(m.shape[-1]):
        col = m[..., k] if sign > 0 else -m[..., k]
        acc = fma(col, x[..., k, None], acc)
    return acc


def jax_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """``index`` as JAX's ``x[index]`` reads an axis of size ``n``: a
    negative index counts from the end, and one still out of range is
    clamped to the nearest end (CEM's discrete actions can be either)."""
    return torch.clamp(torch.where(index < 0, index + n, index), 0, n - 1)


def near_split(x: int, num_bins: int | None = None, size_bins: int | None = None) -> List[int]:
    """Split an integer into near-even bins (reference utils.py:43-58)."""
    if num_bins:
        quotient, remainder = divmod(x, num_bins)
        return [quotient + 1] * remainder + [quotient] * (num_bins - remainder)
    elif size_bins:
        return near_split(x, num_bins=int(np.ceil(x / size_bins)))
    return []


def zip_with_singletons(*args):
    return zip(*(arg if isinstance(arg, list) else itertools.repeat(arg) for arg in args))


def random_dist(generator: torch.Generator, n: int) -> torch.Tensor:
    """A random distribution over ``n`` atoms, on the generator's device."""
    q = torch.rand(n, generator=generator, device=generator.device)
    return q / q.sum()


def all_argmax(x) -> torch.Tensor:
    """Boolean mask of all (near-)maximisers of ``x`` along its last axis
    (reference utils.py:345-351)."""
    x = _f32(x)
    return torch.isclose(x, x.amax(dim=-1, keepdim=True))


def random_argmax(generator: torch.Generator, x) -> torch.Tensor:
    """Uniformly random index among the maximisers of ``x`` along its last
    axis (reference utils.py:354-361: all_argmax + choice)."""
    mask = all_argmax(x)
    weights = mask.reshape(-1, mask.shape[-1]).to(torch.float32)
    return torch.multinomial(weights, 1, generator=generator).reshape(mask.shape[:-1])


def masked_argmax(x, mask) -> torch.Tensor:
    """Argmax of ``x`` along its last axis restricted to ``mask``; -1 where
    the mask is empty."""
    x = torch.where(mask, _f32(x), -torch.inf)
    return torch.where(mask.any(dim=-1), x.argmax(dim=-1), -1)


def kullback_leibler(p, q) -> torch.Tensor:
    """KL(p||q) between categorical distributions on the last axis
    (reference utils.py:72-86)."""
    p = _f32(p)
    q = _f32(q, p)
    ratio = torch.where(p > 0, p, 1.0) / torch.where(q > 0, q, 1.0)
    finite = torch.where(p > 0, p * torch.log(ratio), 0.0).sum(dim=-1)
    has_inf = ((p > 0) & (q <= 0)).any(dim=-1)
    return torch.where(has_inf, torch.inf, finite)


def bernoulli_kullback_leibler(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(B(p) || B(q)) (reference utils.py:89-107)."""
    kl1 = torch.where((p > 0) & (q > 0),
                      p * torch.log(torch.where(q > 0, p / torch.where(q > 0, q, 1.0), 1.0)),
                      0.0)
    log_ratio = torch.log(torch.where((p < 1) & (q < 1),
                                      (1 - p) / torch.where(q < 1, 1 - q, 1.0), 1.0))
    kl2 = torch.where(q < 1, torch.where(p < 1, (1 - p) * log_ratio, 0.0),
                      torch.where(p < 1, torch.inf, 0.0))
    # q == 0 with p > 0: p*log(p/0) = inf
    kl1 = torch.where((p > 0) & (q <= 0), torch.inf, kl1)
    return kl1 + kl2


def d_bernoulli_kullback_leibler_dq(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dKL/dq (B(p)||B(q)) (reference utils.py:110-120)."""
    return (1 - p) / (1 - q) - p / q


def _bounded_newton_step(x, f_x, df_x, a, b):
    """One guarded Newton step with the reference's out-of-bounds relaxation
    (utils.py:191-195): overshoots are pulled back towards the violated bound."""
    x_next = torch.where(df_x != 0, x - f_x / df_x, x)
    x_next = torch.where(torch.isfinite(x_next), x_next, x)
    w = NEWTON_OOB_WEIGHT
    x_next = torch.where(x_next < a, w * a + (1 - w) * x, x_next)
    x_next = torch.where(x_next > b, w * b + (1 - w) * x, x_next)
    return x_next


def kl_upper_bound(_sum, count, threshold=1.0, eps: float = 1e-2, lower: bool = False,
                   device="cuda") -> torch.Tensor:
    """KL-UCB/LCB of an empirical Bernoulli mean (reference utils.py:123-147):
    solves ``KL(mu, q) = threshold / count`` for q in [mu, 1] (upper) or
    [0, mu] (lower), elementwise over broadcastable inputs.

    This is the dense solve ``ops/kl_bound.py::kl_bound`` at
    ``iters=NEWTON_MAX_ITERATIONS``: on a CUDA device one launch of the CUDA
    kernel, on the CPU its plain version."""
    from rl_agents_torch.ops.kl_bound import kl_bound  # that module imports this one

    return kl_bound(_sum, count, threshold, lower=lower, iters=NEWTON_MAX_ITERATIONS, eps=eps,
                    device=device)


def kl_bounds_arena(sums, counts, thresholds, lower: bool = False, eps: float = 1e-3,
                    device="cuda") -> torch.Tensor:
    """KL bound over flat node-statistics tensors."""
    return kl_upper_bound(sums, counts, thresholds, eps=eps, lower=lower, device=device)


def newton_iteration(f, df, eps: float, x0=None, a=-torch.inf, b=torch.inf,
                     max_iterations: int = NEWTON_MAX_ITERATIONS) -> torch.Tensor:
    """Guarded Newton solve of ``f(x) = 0`` on ``[a, b]`` (reference
    utils.py:150-203), elementwise over a batch: ``f`` and ``df`` map a tensor
    of iterates to a tensor of the same shape.

    The JAX package loops while ``|x - x_next| > eps``, per element. Here every
    element takes the same masked trips and one that has converged keeps its
    value, which gives the same result. The trips run in blocks of
    ``NEWTON_BLOCK`` with one read-back between blocks, which ends the loop
    once no element is active: no trip waits for the host, and a batch whose
    slowest element needs a handful of trips does not pay for
    ``max_iterations``. ``newton_iteration.calls`` and ``.trips`` count the
    solves and the trips they ran."""
    a, b = _f32(a), _f32(b)
    if x0 is None:
        x0 = (a + b) / 2
    x_next = _f32(x0, a)
    a, b = a.to(x_next.device), b.to(x_next.device)
    x = torch.full_like(x_next, torch.inf)
    newton_iteration.calls += 1
    for trip in range(max_iterations):
        active = torch.abs(x - x_next) > eps
        if trip and trip % NEWTON_BLOCK == 0 and not bool(active.any()):
            break
        stepped = _bounded_newton_step(x_next, f(x_next), df(x_next), a, b)
        x = torch.where(active, x_next, x)
        x_next = torch.where(active, stepped, x_next)
        newton_iteration.trips += 1
    x_next = torch.minimum(torch.maximum(x_next, a), b)
    return torch.where(a == b, a, x_next)


newton_iteration.calls = newton_iteration.trips = 0


def binary_search(f, eps: float, a, b=None, max_iterations: int = 100) -> torch.Tensor:
    """Bisection for the zero of a non-increasing function (reference
    utils.py:206-249), elementwise over a batch, in ``max_iterations`` masked
    trips. When ``b`` is None the upper bound doubles until it brackets."""
    a = _f32(a)
    grow = torch.full(a.shape, b is None, dtype=torch.bool, device=a.device)
    b = a + 1 if b is None else _f32(b, a).expand_as(a)
    x = torch.full_like(a, torch.nan)
    f_x = torch.full_like(a, torch.inf)
    for _ in range(max_iterations):
        active = torch.abs(f_x) > eps
        mid = (a + b) / 2
        f_mid = f(mid)
        above = f_mid > 0
        new_a = torch.where(above, mid, a)
        new_b = torch.where(above, torch.where(grow, 2 * torch.clamp(b, min=1.0), b), mid)
        a, b = torch.where(active, new_a, a), torch.where(active, new_b, b)
        grow = torch.where(active, grow & above, grow)
        x, f_x = torch.where(active, mid, x), torch.where(active, f_mid, f_x)
    return x


def max_expectation_under_constraint(f, q, c, eps: float = 1e-2) -> torch.Tensor:
    """Solve ``max_p E_p[f]  s.t.  KL(q || p) <= c`` (reference utils.py:292-342)
    for distributions on the last axis: ``f`` and ``q`` are ``[..., n]`` and
    ``c`` is ``[...]``, one problem per leading index.

    All data-dependent branches are masks and the Newton solve is
    ``newton_iteration``'s masked trips, so a batch of problems is one tensor
    program whose only read-back is that solve's, once per block of trips."""
    f = _f32(f)
    q = _f32(q, f)
    c = _f32(c, f)
    n = q.shape[-1]
    if n == 1:
        # single-atom support: p puts all mass on the sole atom and
        # KL(q||p) = 0 <= c always, so the solver is the identity; this static
        # case skips the Newton trips altogether
        return torch.ones_like(q)

    all_zero = (q == 0).all(dim=-1, keepdim=True)
    q = torch.where(all_zero, torch.ones_like(q) / n, q)
    plus = q > 0
    zero = ~plus
    q_p = torch.where(plus, q, 0.0)
    f_star = f.amax(dim=-1)
    f_p_max = torch.where(plus, f, -torch.inf).amax(dim=-1)

    # the JAX package guards its sums with 1e-300, which is 0 in float32: the
    # clamps at 0.0 below are those guards

    def safe_diff(lam):
        return torch.clamp(torch.where(plus, lam[..., None] - f, 1.0), min=1e-12)

    def theta(lam):
        # sum_i q_p log(lam - f_p) + log(sum_i q_p / (lam - f_p)) - c, over plus atoms
        safe = safe_diff(lam)
        t1 = torch.where(plus, q_p * torch.log(safe), 0.0).sum(dim=-1)
        s = torch.where(plus, q_p / safe, 0.0).sum(dim=-1)
        return t1 + torch.log(torch.clamp(s, min=0.0)) - c

    def d_theta(lam):
        safe = safe_diff(lam)
        inv = torch.where(plus, q_p / safe, 0.0)
        s = inv.sum(dim=-1)
        return s - (inv / safe).sum(dim=-1) / torch.clamp(s, min=0.0)

    # Case A: the maximum of f is attained only on zero-mass atoms, and moving
    # mass z there saturates the constraint at lambda = f_star.
    theta_star = theta(f_star)
    case_a = (f_star > f_p_max) & (theta_star < 0)
    z = torch.where(case_a, 1.0 - torch.exp(theta_star), 0.0)
    zero_max = zero & (f == torch.where(zero, f, -torch.inf).amax(dim=-1, keepdim=True))
    zero_max_count = torch.clamp(zero_max.sum(dim=-1).to(torch.float32), min=1.0)
    p_zero = torch.where(case_a[..., None] & zero_max, (z / zero_max_count)[..., None], 0.0)

    # Case B: constant f on the support -> p = q.
    f_p0 = f.gather(-1, plus.to(torch.int64).argmax(dim=-1, keepdim=True))
    constant_f = torch.where(plus, torch.isclose(f, f_p0), True).all(dim=-1)

    # Otherwise: solve theta(lambda) = 0 for lambda >= f_star.
    lam_solved = newton_iteration(theta, d_theta, eps, x0=f_star + 1.0, a=f_star, b=torch.inf)
    lam = torch.where(case_a, f_star, lam_solved)

    safe = safe_diff(lam)
    s = torch.where(plus, q_p / safe, 0.0).sum(dim=-1)
    beta = ((1.0 - z) / torch.clamp(s, min=0.0))[..., None]

    # beta == 0 degenerate fallback: uniform over plus atoms attaining f_star.
    uni = plus & (f == f_star[..., None])
    uni_count = torch.clamp(uni.sum(dim=-1).to(torch.float32), min=1.0)
    p_plus = torch.where(beta <= 0,
                         torch.where(uni, ((1.0 - z) / uni_count)[..., None], 0.0),
                         torch.where(plus, beta * q_p / safe, 0.0))
    p_star = p_plus + p_zero
    return torch.where((constant_f & ~case_a)[..., None], q, p_star)
