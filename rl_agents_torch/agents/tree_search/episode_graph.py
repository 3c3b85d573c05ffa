"""A planner's episode replayed as one CUDA graph.

Where nothing in a planner's episode reads a value back to the host or
draws from a generator, its launches can be captured once and replayed: the
same kernels in the same order on the same buffers, the same bits, with one
host launch in place of hundreds. The planner's own subclass of
``EpisodeGraph`` holds the static buffers its episode reads and writes (its
arena at a capacity, its inputs, one episode's draws), loads a plan's inputs
into them, and hands ``replay`` its episode's body. This module holds what
every such class shares: the capture (one run on a side stream, which builds
and loads what the episode launches, then ``torch.cuda.graph``), the
counters (a replay adds what its capture counted, so each reads as on the
eager path), the captures kept per signature (``Kept``) and an env's part of
a signature (``env_key``).

``capture`` is the one place that touches the card's graph API: a test
that replaces it with a host stand-in runs the rest on the CPU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import torch

from rl_agents_torch.trainer.profiling import counters


def capture(run: Callable[[], None], device: torch.device) -> tuple:
    """Capture ``run`` on ``device`` after one run of it on a side stream.
    Returns ``(replay, counted)``: ``replay()`` replays the captured launches
    on the device's current stream, and ``counted`` is what one run adds to
    the counters. The run and the capture leave the counters as they were;
    the run's writes to the buffers stay."""
    with torch.cuda.device(device):
        before = counters.copy()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = counters.copy()
        with torch.cuda.graph(graph):
            run()
    counted = counters - warm
    counters.subtract(counters - before)

    def replay():
        with torch.cuda.device(device):
            graph.replay()

    return replay, counted


def env_key(env) -> Hashable:
    """What a captured episode reads of ``env``, as a key: its class and its
    attributes, where each is a hashable value other than a tensor (the
    envs' configurations: numbers, strings, tuples, an ``EnvSpec``). Two
    such envs of one class with equal attributes step alike, so they share a
    capture. Any other env is keyed by its identity; the capture holds it."""
    try:
        # each value with its type: 1, 1.0 and True are equal, and may step apart
        attributes = tuple((name, type(value), value) for name, value in sorted(vars(env).items()))
        hash(attributes)
    except TypeError:  # no attributes of its own, or one that cannot be hashed
        return type(env), id(env)
    if any(isinstance(value, torch.Tensor) for _, _, value in attributes):
        return type(env), id(env)
    return type(env), attributes


class EpisodeGraph:
    """One planner's episode of one signature, captured in the first
    ``replay`` and replayed in every one. A subclass sets ``prefix`` (its
    counters are ``<prefix>.episode_graph.captures`` and ``.replays``), holds
    its static buffers on ``device``, defines ``_clear`` (the buffers as a
    plan starts) and copies an episode's inputs in before ``replay``."""

    prefix = ""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = self.counted = None

    def _clear(self):
        raise NotImplementedError

    def replay(self, run: Callable[[], None]):
        """Replay the episode. The first call captures ``run``, the episode's
        body on the static buffers, from the inputs loaded, then clears the
        buffers that the capture's run wrote."""
        if self.graph is None:
            self.graph, self.counted = capture(run, self.device)
            counters[f"{self.prefix}.episode_graph.captures"] += 1
            self._clear()
        self.graph()
        counters.update(self.counted)
        counters[f"{self.prefix}.episode_graph.replays"] += 1


class Kept:
    """Captures kept per signature, the most recently used last, at most
    ``size`` of them; each holds its buffers and its graph's memory."""

    def __init__(self, size: int):
        self.size = size
        self.graphs: OrderedDict = OrderedDict()

    def get(self, key: Hashable, make: Callable[[], EpisodeGraph],
            fits: Callable[[EpisodeGraph], bool] = lambda kept: True) -> EpisodeGraph:
        """The capture kept under ``key``; a new one from ``make()``, not yet
        captured, where none is kept or the kept one does not ``fits``."""
        kept = self.graphs.pop(key, None)
        if kept is None or not fits(kept):
            kept = make()
        self.graphs[key] = kept
        while len(self.graphs) > self.size:
            self.graphs.popitem(last=False)
        return kept
