#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rl_agents_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
non-zero without its final line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   no CUDA device is an error;
2. build the hand-written kernels from the repository's sources;
3. hold each kernel against its plain PyTorch version on the card, and time
   both at the planner's shape;
4. the batch path at full width: ``olop_plan_batch`` on CartPole, 4096 trees,
   23 episodes x horizon 8, gamma 0.95, checked against the same first 64
   trees planned on the CPU with the plain KL solve;
5. the agent path through the user's entry points: ``load_environment`` /
   ``load_agent`` / ``Evaluation.test`` for one CartPole episode on the card,
   with every kernel launch counter set to 0 just before and read just after;
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


def check_kl_bound(dev) -> dict:
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_torch, kl_bound_trips
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = [(n, kl_inputs(n, rng, dev)) for n in (TREES, 1_000_003)] + [(8, kl_edge_inputs(dev))]
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

    # time at the planner's shape: one call per (episode, depth) over 4096 trees
    inputs = kl_inputs(TREES, rng, dev)
    run_kernel = lambda: kl_bound(*inputs, iters=NEWTON_MAX_ITERATIONS, device=dev)  # noqa: E731
    run_plain = lambda: kl_bound_torch(*inputs, iters=NEWTON_MAX_ITERATIONS)  # noqa: E731
    for _ in range(20):
        run_kernel()
    run_plain()
    # the kernel's own device time: 100 launches captured in a CUDA graph and
    # replayed, so no host work sits between them; the eager call time
    # (wrapper and launch from Python) is reported beside it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            run_kernel()
    graph.replay()
    ms = cuda_ms(graph.replay, 20) / 100
    call_ms = cuda_ms(run_kernel, 500)
    plain_ms = cuda_ms(run_plain, 20)
    trips = int(kl_bound_trips(*inputs, iters=NEWTON_MAX_ITERATIONS).sum())
    bytes_moved = 16 * TREES  # three f32 inputs read once, one f32 output written once
    ops = trips * KL_OPS_PER_TRIP + TREES * KL_OPS_SETUP
    bytes_s, ops_s = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    bound_ms = max(bytes_s, ops_s) * 1e3
    print(f"kl_bound n={TREES} iters={NEWTON_MAX_ITERATIONS}: kernel {ms!r} ms on the device, "
          f"{call_ms!r} ms per eager call, plain {plain_ms!r} ms, "
          f"bound {bound_ms!r} ms ({bytes_moved} bytes, {ops} f32 ops over {trips} Newton trips)")
    return {"name": "kl_bound", "route": "cuda", "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations", "library_ms": None,
            "call_ms": call_ms}


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
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3!r} ms in {e.count} x {e.key[:90]}")


def check_batch_path(dev):
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch
    from rl_agents_torch.convert import tree_to_numpy
    from rl_agents_torch.envs.cartpole import CartPoleEnv, CartPoleState
    from rl_agents_torch.ops.kl_bound import kl_bound

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
    kl_bound.launches = 0
    for _ in range(5):
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        actions, lengths, tree = olop_plan_batch(env, params, states0, device=dev, **kw)
        end_ev.record()
        torch.cuda.synchronize()
        times.append(start_ev.elapsed_time(end_ev))
    launches = kl_bound.launches
    if launches != 5 * EPISODES * HORIZON:
        raise AssertionError(f"{launches} kl_bound launches in 5 plans, expected {5 * EPISODES * HORIZON}")
    ms = statistics.median(times)
    env_steps = TREES * EPISODES * HORIZON
    print(f"olop_plan_batch B={TREES} episodes={EPISODES} horizon={HORIZON}: median {ms!r} ms "
          f"per plan over {[round(t, 3) for t in times]}, {env_steps / (ms / 1e3)!r} env-steps/s, "
          f"{launches // 5} kl_bound launches per plan")

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


def check_agent_path(dev) -> int:
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.ops.kl_bound import kl_bound
    from rl_agents_torch.trainer.evaluation import Evaluation

    env_config = json.loads((REPO / "scripts" / "configs" / "CartPoleEnv" / "env.json").read_text())
    env_config["max_episode_steps"] = AGENT_MAX_STEPS
    env = load_environment(env_config, device=dev)
    agent = load_agent(dict(AGENT_CONFIG), env, device=dev)
    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke", num_episodes=1,
                            training=False, sim_seed=0)
    kl_bound.launches = 0
    started = time.time()
    evaluation.test()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = kl_bound.launches
    episode = json.loads((evaluation.run_directory / Evaluation.EPISODES_FILE).read_text().splitlines()[-1])
    per_plan = agent.config["episodes"] * agent.config["horizon"]
    print(f"agent path: OLOPAgent budget {AGENT_CONFIG['budget']} "
          f"({agent.config['episodes']} episodes x horizon {agent.config['horizon']}), "
          f"return {episode['total_reward']!r} in {episode['length']} steps, {seconds!r} s "
          f"({seconds / episode['length']!r} s per step), kl_bound launches {launches}")
    if launches <= 0 or launches != per_plan * episode["length"]:
        raise AssertionError(f"{launches} kl_bound launches, expected {per_plan} per step")
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
    kernel = check_kl_bound(dev)

    phase("4. batch path")
    check_batch_path(dev)

    phase("5. agent path")
    kernel["launches"] = check_agent_path(dev)

    phase("6. summary")
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
