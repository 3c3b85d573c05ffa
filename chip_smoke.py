#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rl_agents_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
non-zero without its final line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   no CUDA device is an error;
2. build the hand-written kernels from the repository's sources;
3. hold each kernel against its plain PyTorch version on the card, and time
   both: the KL bound's dense form ``kl_bound`` at n = 4096 and n = 2^24, and
   its indexed form ``kl_bound_indexed_`` on a ``[4096, 369]`` arena at the
   planner's path of 8 x 4096 nodes;
4. the batch path at full width: ``olop_plan_batch`` on CartPole, 4096 trees,
   23 episodes x horizon 8, gamma 0.95, one ``kl_bound_indexed_`` launch per
   episode, checked against the same first 64 trees planned on the CPU with
   the plain KL solve;
5. the agent path through the user's entry points: ``load_environment`` /
   ``load_agent`` / ``Evaluation.test`` for one CartPole episode on the card,
   with every kernel launch counter set to 0 just before and read just after
   (one ``kl_bound_indexed_`` launch per planning episode; the dense form is
   not on this path);
6. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` as the last
   line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bandwidth, and f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations of csrc/kl_bound.cu counted from its source: one Newton trip
# (KL: 9 with its two logf, minus the divergence: 1, derivative: 5, step: 2,
# |dx|: 1) and the per-element set-up (mu, divergence, midpoint: 4)
KL_OPS_PER_TRIP = 18
KL_OPS_SETUP = 4
KL_TOLERANCE = 1e-5

TREES, EPISODES, HORIZON, GAMMA = 4096, 23, 8, 0.95
ARENA = 1 + EPISODES * HORIZON * 2  # nodes per tree of the CartPole plan (2 actions)
DENSE_LARGE = 1 << 24  # the dense form where bytes should bind
CPU_SUBSET = 64
AGENT_CONFIG = {"__class__": "OLOPAgent", "budget": 184, "gamma": GAMMA}
AGENT_MAX_STEPS = 30


def phase(title: str):
    print(f"== {title}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``reps`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def kl_inputs(n: int, rng: np.random.Generator, device):
    """OLOP-like node statistics: counts up to the episode count, sums of
    Bernoulli rewards, thresholds c*log(t)."""
    count = rng.integers(0, EPISODES + 1, n).astype(np.float32)
    total = np.floor(rng.random(n) * (count + 1)).astype(np.float32)
    thr = (4.0 * np.log(rng.integers(1, EPISODES + 1, n))).astype(np.float32)
    return tuple(torch.tensor(v, device=device) for v in (total, count, thr))


def kl_edge_inputs(device):
    total = [0.0, 0.0, 5.0, 0.0, 3.0, 0.5, 1e6, 7.0]
    count = [0.0, 3.0, 5.0, 4.0, 0.0, 1.0, 1e6 + 1, 7.0]
    thr = [2.0, 2.0, 2.0, 2.0, 2.0, float(np.log(10.0)), 0.0, 0.0]
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (total, count, thr))


def time_kernel(run_kernel, run_plain, per_graph: int, replays: int, eager: int, plain: int):
    """(device ms per launch, ms per eager call, plain version's ms per call).
    The device time comes from ``per_graph`` launches captured in a CUDA
    graph and replayed, so no host work sits between them; the eager call
    (wrapper and launch from Python) is timed beside it."""
    for _ in range(3):
        run_kernel()
    run_plain()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            run_kernel()
    graph.replay()
    ms = cuda_ms(graph.replay, replays) / per_graph
    return ms, cuda_ms(run_kernel, eager), cuda_ms(run_plain, plain)


def kl_bound_of(bytes_moved: int, _sum, count, threshold, lower: bool, iters: int):
    """(bound ms, "bytes" or "operations", f32 ops, Newton trips, lane use):
    the least time of a solve of these inputs. Trips are those the inputs
    need: none where the kernel skips the loop (n == 0, or a mean on its
    bound). Lane use is the share of the warps' trips that do work: element i
    runs on lane i % 32 of warp i // 32, and a warp takes as many trips as
    its longest lane."""
    from rl_agents_torch.ops.kl_bound import kl_bound_trips

    mu = _sum / torch.clamp(count, min=1.0)
    needed = (count != 0) & (mu != (0.0 if lower else 1.0))
    per_lane = torch.where(needed, kl_bound_trips(_sum, count, threshold, lower=lower,
                                                  iters=iters), 0).flatten()
    trips = int(per_lane.sum())
    per_lane = torch.nn.functional.pad(per_lane, (0, -per_lane.numel() % 32))
    lane_use = trips / max(32 * int(per_lane.view(-1, 32).amax(dim=1).sum()), 1)
    ops = trips * KL_OPS_PER_TRIP + count.numel() * KL_OPS_SETUP
    bytes_s, ops_s = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations", ops, trips,
            lane_use)


def check_kl_bound(dev) -> dict:
    """The dense form against its plain version at the planner's former
    shape, a large odd size, 2^24 and the edge cases; timed at n = 4096 (the
    per-depth shape of earlier slices) and n = 2^24 (bytes-bound)."""
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_torch
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = [(n, kl_inputs(n, rng, dev)) for n in (TREES, 1_000_003, DENSE_LARGE)]
    cases.append((8, kl_edge_inputs(dev)))
    for n, inputs in cases:
        for lower in (False, True):
            for iters in (24, NEWTON_MAX_ITERATIONS):
                got = kl_bound(*inputs, lower=lower, iters=iters, device=dev)
                want = kl_bound_torch(*inputs, lower=lower, iters=iters)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                print(f"kl_bound n={n} lower={lower} iters={iters}: max|kernel - plain| = {err!r}")
                if not err <= KL_TOLERANCE:
                    raise AssertionError(f"kl_bound disagrees with its plain version: {err!r}")
                worst = max(worst, err)
    del cases

    timed = {}
    for n, reps in ((TREES, (100, 20, 500, 20)), (DENSE_LARGE, (10, 5, 20, 3))):
        inputs = kl_inputs(n, rng, dev)
        ms, call_ms, plain_ms = time_kernel(
            lambda: kl_bound(*inputs, iters=NEWTON_MAX_ITERATIONS, device=dev),
            lambda: kl_bound_torch(*inputs, iters=NEWTON_MAX_ITERATIONS), *reps)
        # three f32 inputs read once, one f32 output written once
        bound_ms, bound_by, ops, trips, lane_use = kl_bound_of(16 * n, *inputs, False,
                                                               NEWTON_MAX_ITERATIONS)
        print(f"kl_bound n={n} iters={NEWTON_MAX_ITERATIONS}: kernel {ms!r} ms on the device, "
              f"{call_ms!r} ms per eager call, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
              f"by {bound_by} ({16 * n} bytes, {ops} f32 ops over {trips} Newton trips, "
              f"lane use {lane_use!r}), {bound_ms / ms!r} of the bound")
        timed[n] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        del inputs
    large = {f"{key}_n{DENSE_LARGE}": value for key, value in timed[DENSE_LARGE].items()}
    return {"name": "kl_bound", "route": "cuda", "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, **timed[TREES], "library_ms": None, "on_main_path": False,
            **large}


def kl_arena(rng: np.random.Generator, device):
    """An OLOP-sized arena ``[TREES, ARENA]`` of OLOP-like statistics, a
    path ``[HORIZON, TREES]`` of distinct non-root nodes per tree and the
    threshold 4 log(EPISODES), as the planner hands them to the indexed form."""
    total, count, _ = kl_inputs(TREES * ARENA, rng, device)
    nodes = np.argsort(rng.random((TREES, ARENA - 1)), axis=1)[:, :HORIZON].T + 1
    return (total.reshape(TREES, ARENA), count.to(torch.int64).reshape(TREES, ARENA),
            torch.tensor(np.ascontiguousarray(nodes), device=device),
            torch.tensor(4.0 * np.log(EPISODES), dtype=torch.float32, device=device))


def check_kl_bound_indexed(dev) -> dict:
    """The indexed form against its plain version on an OLOP-sized arena,
    lower and upper, iters 24 and 100; entries off the path must stay as
    they were. Timed at the planner's 8 x 4096 path."""
    from rl_agents_torch.ops.kl_bound import kl_bound_indexed_, kl_bound_indexed_torch_
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    rng = np.random.default_rng(2)
    total, count, nodes, thr = kl_arena(rng, dev)
    on_path = torch.zeros(total.shape, dtype=torch.bool, device=dev)
    on_path[torch.arange(TREES, device=dev).expand_as(nodes), nodes] = True
    base = torch.full(total.shape, -7.0, device=dev)
    worst = 0.0
    for lower in (False, True):
        for iters in (24, NEWTON_MAX_ITERATIONS):
            got = kl_bound_indexed_(base.clone(), total, count, nodes, thr, lower=lower,
                                    iters=iters)
            want = kl_bound_indexed_torch_(base.clone(), total, count, nodes, thr, lower=lower,
                                           iters=iters)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            untouched = torch.equal(got[~on_path], base[~on_path])
            print(f"kl_bound_indexed_ arena {TREES}x{ARENA} path {HORIZON}x{TREES} lower={lower} "
                  f"iters={iters}: max|kernel - plain| = {err!r}, off-path entries unchanged: "
                  f"{untouched}")
            if not (err <= KL_TOLERANCE and untouched):
                raise AssertionError(f"kl_bound_indexed_ disagrees with its plain version: "
                                     f"{err!r}, off-path unchanged: {untouched}")
            worst = max(worst, err)

    out = base.clone()
    ms, call_ms, plain_ms = time_kernel(
        lambda: kl_bound_indexed_(out, total, count, nodes, thr, iters=NEWTON_MAX_ITERATIONS),
        lambda: kl_bound_indexed_torch_(out, total, count, nodes, thr,
                                        iters=NEWTON_MAX_ITERATIONS), 100, 20, 500, 20)
    # no Newton trip: what the launch, index loads, gathers and scatter cost
    floor_ms = time_kernel(lambda: kl_bound_indexed_(out, total, count, nodes, thr, iters=0),
                           lambda: None, 100, 20, 1, 1)[0]
    rows = torch.arange(TREES, device=dev).expand_as(nodes)
    elements = nodes.numel()
    # an 8 B index, an 8 B count and a 4 B sum read once, a 4 B bound written once
    bytes_moved = 24 * elements
    bound_ms, bound_by, ops, trips, lane_use = kl_bound_of(
        bytes_moved, total[rows, nodes], count[rows, nodes].to(torch.float32), thr, False,
        NEWTON_MAX_ITERATIONS)
    print(f"kl_bound_indexed_ {elements} path nodes, iters={NEWTON_MAX_ITERATIONS}: kernel {ms!r} "
          f"ms on the device, {call_ms!r} ms per eager call, plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms by {bound_by} ({bytes_moved} bytes, {ops} f32 ops over {trips} Newton "
          f"trips, lane use {lane_use!r}), {bound_ms / ms!r} of the bound")
    print(f"kl_bound_indexed_ {elements} path nodes, iters=0 (launch, loads, gathers and "
          f"scatter, no Newton trip): {floor_ms!r} ms on the device")
    return {"name": "kl_bound_indexed_", "route": "cuda",
            "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "call_ms": call_ms, "on_main_path": True}


def profile_plan(plan):
    """Device busy share of one plan and its costliest device kernels, from
    torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        plan()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - started) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # kernels attributed to the host ops that launched them
        kernels = [e for e in events if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if busy_us <= 0:
        print("profiled plan: the profiler recorded no device time (device busy share not measured)")
        return
    print(f"profiled plan: {wall_us / 1e3!r} ms wall, device busy {busy_us / 1e3!r} ms "
          f"({busy_us / wall_us!r} of wall), {launches} device kernels")
    kl = [e for e in kernels if "kl_bound" in e.key]
    print(f"  KL kernel: {sum(e.self_device_time_total for e in kl) / 1e3!r} ms in "
          f"{sum(e.count for e in kl)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3!r} ms in {e.count} x {e.key[:90]}")


def check_batch_path(dev):
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch
    from rl_agents_torch.convert import tree_to_numpy
    from rl_agents_torch.envs.cartpole import CartPoleEnv, CartPoleState
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_indexed_

    env = CartPoleEnv(max_episode_steps=200)
    rng = np.random.default_rng(1)
    start = rng.uniform(-0.05, 0.05, (4, TREES)).astype(np.float32)

    def states(device, n):
        return CartPoleState(*(torch.tensor(v[:n], device=device) for v in start),
                             t=torch.zeros(n, dtype=torch.int64, device=device),
                             done=torch.zeros(n, dtype=torch.bool, device=device))

    kw = dict(num_actions=2, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA, threshold_coeff=4.0)
    params, states0 = env.default_params(dev), states(dev, TREES)
    actions, lengths, tree = olop_plan_batch(env, params, states0, device=dev, **kw)  # warm-up
    times = []
    kl_bound.launches = kl_bound_indexed_.launches = 0
    for _ in range(5):
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        actions, lengths, tree = olop_plan_batch(env, params, states0, device=dev, **kw)
        end_ev.record()
        torch.cuda.synchronize()
        times.append(start_ev.elapsed_time(end_ev))
    launches = kl_bound_indexed_.launches
    if launches != 5 * EPISODES or kl_bound.launches != 0:
        raise AssertionError(f"{launches} kl_bound_indexed_ and {kl_bound.launches} kl_bound "
                             f"launches in 5 plans, expected {5 * EPISODES} and 0")
    ms = statistics.median(times)
    env_steps = TREES * EPISODES * HORIZON
    print(f"olop_plan_batch B={TREES} episodes={EPISODES} horizon={HORIZON}: median {ms!r} ms "
          f"per plan over {[round(t, 3) for t in times]}, {env_steps / (ms / 1e3)!r} env-steps/s, "
          f"{launches // 5} kl_bound_indexed_ launches per plan")

    profile_plan(lambda: olop_plan_batch(env, params, states0, device=dev, **kw))

    actions_np, lengths_np = actions.cpu().numpy(), lengths.cpu().numpy()
    if not (((actions_np >= 0) & (actions_np < 2)) | (actions_np == -1)).all() \
            or not ((lengths_np >= 1) & (lengths_np <= HORIZON)).all() \
            or not torch.isfinite(tree.value_upper).all():
        raise AssertionError("batch plan produced invalid actions, lengths or bounds")
    cpu = torch.device("cpu")
    ref_actions, ref_lengths, ref_tree = olop_plan_batch(
        env, env.default_params(cpu), states(cpu, CPU_SUBSET), device=cpu, **kw)
    sub = tree_to_numpy(tree)
    ref = tree_to_numpy(ref_tree)
    if not (np.array_equal(actions_np[:CPU_SUBSET], ref_actions.numpy())
            and np.array_equal(lengths_np[:CPU_SUBSET], ref_lengths.numpy())
            and np.array_equal(sub.parent[:CPU_SUBSET], ref.parent)
            and np.array_equal(sub.count[:CPU_SUBSET], ref.count)):
        raise AssertionError("the GPU batch plan differs from its CPU subset")
    value_err = float(np.abs(sub.value_upper[:CPU_SUBSET] - ref.value_upper).max())
    if not value_err <= KL_TOLERANCE:
        raise AssertionError(f"value_upper differs from the CPU subset by {value_err!r}")
    print(f"first {CPU_SUBSET} trees equal to the CPU plan (actions, lengths, parents, counts); "
          f"max|value_upper diff| = {value_err!r}")


def check_agent_path(dev) -> dict:
    """Launches of each KL wrapper in one agent episode, by name."""
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_indexed_
    from rl_agents_torch.trainer.evaluation import Evaluation

    env_config = json.loads((REPO / "scripts" / "configs" / "CartPoleEnv" / "env.json").read_text())
    env_config["max_episode_steps"] = AGENT_MAX_STEPS
    env = load_environment(env_config, device=dev)
    agent = load_agent(dict(AGENT_CONFIG), env, device=dev)
    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke", num_episodes=1,
                            training=False, sim_seed=0)
    kl_bound.launches = kl_bound_indexed_.launches = 0
    started = time.time()
    evaluation.test()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = {"kl_bound": kl_bound.launches, "kl_bound_indexed_": kl_bound_indexed_.launches}
    episode = json.loads((evaluation.run_directory / Evaluation.EPISODES_FILE).read_text().splitlines()[-1])
    per_plan = agent.config["episodes"]
    print(f"agent path: OLOPAgent budget {AGENT_CONFIG['budget']} "
          f"({agent.config['episodes']} episodes x horizon {agent.config['horizon']}), "
          f"return {episode['total_reward']!r} in {episode['length']} steps, {seconds!r} s "
          f"({seconds / episode['length']!r} s per step), launches {launches}")
    if launches["kl_bound_indexed_"] != per_plan * episode["length"] or launches["kl_bound"] != 0:
        raise AssertionError(f"launches {launches}, expected {per_plan} kl_bound_indexed_ "
                             "per step and no kl_bound")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    sys.path.insert(0, str(REPO))
    from rl_agents_torch.ops import kl_bound as kl_module

    phase("1. card")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    phase("2. build")
    started = time.time()
    library = kl_module.build()
    print(f"kl_bound built in {time.time() - started!r} s: {library.relative_to(REPO)}")
    log = library.with_suffix(".so.log")
    if log.is_file():
        print(log.read_text().strip())

    phase("3. kernels against their plain versions")
    kernels = [check_kl_bound(dev), check_kl_bound_indexed(dev)]

    phase("4. batch path")
    check_batch_path(dev)

    phase("5. agent path")
    launches = check_agent_path(dev)
    for kernel in kernels:
        kernel["launches"] = launches[kernel["name"]]

    phase("6. summary")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
