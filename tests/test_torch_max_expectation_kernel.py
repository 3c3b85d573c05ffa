"""The constrained-KL expectation's hand-written CUDA kernel
(``csrc/max_expectation.cu``, ``ops/max_expectation.py``) and the rule by
which ``utils/math.py::max_expectation_under_constraint`` takes it.

A solve has two outcomes: a launch of the kernel, where an input is a CUDA
tensor (``max_expectation_under_constraint.kernel_launches``), or the plain
version ``_max_expectation`` (``.eager_calls``). On the CPU every solve runs
the plain version and the wrapper refuses what it is given. The card tests
(marker ``card``; they skip without one) hold the kernel bit for bit against
``_max_expectation`` run eagerly on the card: the MDP-GapE cell's problems,
case A, an all-zero q, ties at the largest f, every atom count the kernel
takes, three Newton steps, broadcast inputs and a launch inside a CUDA-graph
capture; they check that a launch reads nothing back and that what the kernel
does not take raises, and time a launch. Run them on the card with
``python -m pytest tests/test_torch_max_expectation_kernel.py -m card -s``."""
import math
import re
import time

import pytest
import torch

from rl_agents_torch.ops import max_expectation as kernel
from rl_agents_torch.trainer.profiling import counters
from rl_agents_torch.utils import math as tm

LAUNCHES = "max_expectation_under_constraint.kernel_launches"
EAGER = "max_expectation_under_constraint.eager_calls"


def _counted(run):
    """``run()`` and the kernel launches, eager calls and host syncs it counted."""
    before = counters.copy()
    out = run()
    counted = counters - before
    return out, (counted[LAUNCHES], counted[EAGER], counted["host.syncs"])


def _problems(rows: int, n: int, device, seed: int):
    """Problems drawn as MDP-GapE's chance backups make them: values in
    [0, 3), empirical next-state frequencies from counts in 0..4 (rows of
    zero counts among them), the budget 0.1 log(20) over the count; every
    seventh row nearly constant (the solves that run every Newton trip) and
    every eleventh constant."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.rand((rows, n), generator=gen, device=device) * 3.0
    f[::7, 1:] = f[::7, :1] + 3e-4
    f[::11, 1:] = f[::11, :1]
    counts = torch.randint(0, 5, (rows, n), generator=gen, device=device)
    q = counts.float() / counts.sum(dim=1, keepdim=True).clamp(min=1).float()
    c = 0.1 * math.log(20) / counts.sum(dim=1).clamp(min=1).float()
    return f, q, c


# --------------------------------------------------------------------- CPU

def test_on_the_cpu_every_solve_runs_the_plain_version(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(kernel, "launch", forbidden)
    f, q, c = _problems(64, 3, "cpu", 3)
    p, delta = _counted(lambda: tm.max_expectation_under_constraint(f, q, c))
    assert delta == (0, 1, delta[2]) and p.shape == (64, 3)
    assert torch.equal(p, tm._max_expectation(f, q, c, 1e-2))


@pytest.mark.parametrize("case", ["cpu tensors", "f not a tensor", "c a string"])
def test_the_wrapper_refuses_what_is_not_on_a_card(case):
    f, q, c = _problems(8, 2, "cpu", 4)
    args = {"cpu tensors": (f, q, c), "f not a tensor": (f.tolist(), q, c),
            "c a string": (f, q, "0.1")}[case]
    with pytest.raises(ValueError):
        kernel.launch(*args)


def test_the_atom_counts_are_the_sources():
    source = kernel.SOURCE.read_text()
    low = int(re.search(r"kMinAtoms = (\d+);", source).group(1))
    high = int(re.search(r"kMaxAtoms = (\d+);", source).group(1))
    assert kernel.ATOMS == range(low, high + 1)


# -------------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _launch_against_eager(f, q, c, eps: float = 1e-2, materialised=None):
    """One launch equal to the plain version run eagerly on the card, bit for
    bit (on ``materialised`` inputs where given), with no host sync; returns
    the kernel's output."""
    p, delta = _counted(lambda: tm.max_expectation_under_constraint(f, q, c, eps))
    assert delta == (1, 0, 0)
    want = tm._max_expectation(*(materialised or (f, q, c)), eps)
    assert p.shape == want.shape and p.dtype == torch.float32
    assert torch.equal(p, want), f"{int((p != want).sum())} of {p.numel()} atoms differ"
    return p


@pytest.mark.card
def test_the_cells_problems_give_the_eager_bits():
    """The chance backups' solve at the cell's shape ``[2 x 4096, 2]``,
    launched three times, once under ``set_sync_debug_mode("error")``."""
    dev = _card()
    f, q, c = _problems(2 * 4096, 2, dev, 2**33 + 7)
    for _ in range(2):
        _launch_against_eager(f, q, c)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        p = tm.max_expectation_under_constraint(f, q, c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(p, tm._max_expectation(f, q, c, 1e-2))


@pytest.mark.card
@pytest.mark.parametrize("n", list(kernel.ATOMS))
def test_every_atom_count_gives_the_eager_bits(n):
    dev = _card()
    f, q, c = _problems(4096, n, dev, 2**32 + n)
    _launch_against_eager(f, q, c)


@pytest.mark.card
@pytest.mark.parametrize("eps", [1e-2, 1e-3, 1e-4])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_each_newton_step_gives_the_eager_bits(n, eps):
    dev = _card()
    f, q, c = _problems(4096, n, dev, 2**31 + 100 * n)
    _launch_against_eager(f, q, c, eps)


@pytest.mark.card
@pytest.mark.parametrize("n", [2, 4, 7])
def test_the_cases_give_the_eager_bits(n):
    """Case A (the largest f only on zero-mass atoms, at budgets above and
    below the one it saturates), q all zero, and ties at the largest f on
    the support and off it."""
    dev = _card()
    rows = 1024
    f, q, c = _problems(rows, n, dev, 2**34 + n)
    part = rows // 4
    q[:part, 0] = 0.0  # case A: the largest f on a zero-mass atom
    f[:part, 0] = f[:part].amax(dim=1) + torch.linspace(0.0, 2.0, part, device=dev)
    c[:part] = torch.linspace(1e-3, 3.0, part, device=dev)
    q[part:2 * part] = 0.0  # taken as uniform
    ties = slice(2 * part, 3 * part)  # two atoms at the largest f
    f[ties, 1] = f[ties].amax(dim=1)
    f[ties, 0] = f[ties, 1]
    q[ties.start::2, 0] = 0.0  # one of them without mass in every other row
    q = q / q.sum(dim=1, keepdim=True).clamp(min=1e-30)
    q[part:2 * part] = 0.0
    _launch_against_eager(f, q, c)


@pytest.mark.card
def test_broadcast_inputs_give_the_eager_bits_of_their_rows():
    """``q`` given once for every row, ``c`` as a number, a 0-d tensor or
    one value a batch, ``f`` shared across a batch axis: the kernel solves
    each row as the plain version solves the inputs broadcast to full,
    contiguous rows."""
    dev = _card()
    rows = 2048
    f, q, c = _problems(rows, 3, dev, 2**31 + 3)
    q_row = torch.tensor([0.25, 0.0, 0.75], device=dev)
    full_q = q_row.expand(rows, 3).contiguous()
    full_c = torch.full((rows,), 0.3, device=dev)
    for c_given in (0.3, torch.tensor(0.3, device=dev), torch.tensor([0.3], device=dev)):
        _launch_against_eager(f, q_row, c_given, materialised=(f, full_q, full_c))
    qs = torch.stack([q, q.flip(0), q.roll(1, 0), q.roll(2, 0)])
    per_batch = torch.tensor([[0.05], [0.2], [0.5], [1.5]], device=dev)
    _launch_against_eager(f[None], qs, per_batch,
                          materialised=(f.expand(4, rows, 3).contiguous(), qs,
                                        per_batch.expand(4, rows).contiguous()))


@pytest.mark.card
def test_a_launch_inside_a_graph_capture_gives_the_same_bits():
    dev = _card()
    f, q, c = _problems(2 * 4096, 2, dev, 2**32 + 99)
    want = tm._max_expectation(f, q, c, 1e-2)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the library loaded, the pool warmed
        tm.max_expectation_under_constraint(f, q, c)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        p = tm.max_expectation_under_constraint(f, q, c)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(p, want)
    f.copy_(f.flip(0))
    graph.replay()
    assert torch.equal(p, tm._max_expectation(f, q, c, 1e-2))


@pytest.mark.card
def test_what_the_kernel_does_not_take_raises():
    """The wrapper refuses float64; the public function casts it to float32
    first, as it does on the CPU, and solves that. A device mix, an atom
    count the kernel does not take and f and q of other widths raise."""
    dev = _card()
    f, q, c = _problems(64, 2, dev, 5)
    with pytest.raises(ValueError):
        kernel.launch(f.double(), q.double(), c.double())
    cast, delta = _counted(lambda: tm.max_expectation_under_constraint(
        f.double(), q.double(), c.double()))
    assert delta == (1, 0, 0) and torch.equal(cast, tm._max_expectation(f, q, c, 1e-2))
    cases = {"q on the CPU": (f, q.cpu(), c),
             "c on the CPU": (f, q, c.cpu()),
             "17 atoms": (torch.rand(8, 17, device=dev), torch.full((8, 17), 1 / 17, device=dev),
                          c[:8]),
             "f and q of other widths": (f, q[:, :1].expand(64, 3), c)}
    for name, args in cases.items():
        with pytest.raises(ValueError):
            tm.max_expectation_under_constraint(*args)
    # one atom: all the mass on it, no launch
    one, delta = _counted(lambda: tm.max_expectation_under_constraint(f[:, :1], q[:, :1], c))
    assert delta == (0, 0, 0) and torch.equal(one, torch.ones_like(q[:, :1]))


def _device_ms(call, dev, n: int = 50) -> float:
    """Device time a call: ``n`` calls captured in one CUDA graph and
    replayed between two CUDA events, so that the host's enqueue is not in
    it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def _wall_ms(call, dev, n: int = 5) -> float:
    """Wall time a call, ending in a synchronise: the plain version reads
    back between its blocks of Newton trips, so no graph captures it."""
    call()
    torch.cuda.synchronize(dev)
    started = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - started) / n * 1e3


@pytest.mark.card
def test_time_a_launch():
    """The kernel's device time a launch and host time a call at the
    MDP-GapE cell's ``[8192, 2]`` and at ``[1024, 3]``, beside its bound by
    bytes (f, q and c read, p written, at 3.35 TB/s) and the plain version's
    wall time a call; printed for PERF.md."""
    dev = _card()
    print(torch.cuda.get_device_name(dev))
    for rows, n in ((8192, 2), (1024, 3)):
        f, q, c = _problems(rows, n, dev, 2**31 + rows)
        call = lambda: tm.max_expectation_under_constraint(f, q, c)
        call()
        device_ms = _device_ms(call, dev)
        torch.cuda.synchronize(dev)
        started = time.perf_counter()
        for _ in range(200):
            call()
        host_us = (time.perf_counter() - started) / 200 * 1e6
        torch.cuda.synchronize(dev)
        eager_ms = _wall_ms(lambda: tm._max_expectation(f, q, c, 1e-2), dev)
        bound_ms = 4 * (3 * rows * n + rows) / 3.35e12 * 1e3
        print(f"[{rows}, {n}]: kernel {device_ms!r} ms a launch on the device, {host_us!r} us of "
              f"host time a call; bound {bound_ms!r} ms ({100 * bound_ms / device_ms!r}%); "
              f"plain version {eager_ms!r} ms a call")
        assert device_ms > 0
