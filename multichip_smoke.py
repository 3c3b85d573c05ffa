#!/usr/bin/env python3
"""The port's sharded paths across several cards of one host.

    python3 multichip_smoke.py                 # one rank per visible card, NCCL
    python3 multichip_smoke.py --ranks 4 --device cpu --trees 64   # gloo, CPU

Starts one process per rank (``torch.multiprocessing`` spawn, the group at
``tcp://localhost:<free port>``), joins them with
``maybe_initialize_distributed`` and lays them out with ``make_pod_mesh``,
then drives:

1. ``make_sharded_actor_learner`` at ``chip_smoke.py``'s phase-36 sizes
   (4 shards x 2 envs; CartPole with a (64, 64) MLP for 12 steps, the
   EgoAttention flagship on highway for 8), the shards split over the ranks:
   the gathered rings, the counters and every rank's parameters against the
   whole program run on the CPU by rank 0 under the same injected draws
   (actions, terminals and counters equal, rewards within
   ``chip_smoke.SHARDED_REWARD_TOLERANCE``, parameters within 1e-5), ms a
   step of a second segment, and a profiled step's all-reduce calls and
   NCCL kernels on rank 0;
2. ``sharded_planner_batch`` over KL-OLOP on CartPole at ``chip_smoke.py``'s
   phase-4 sizes (4096 trees x 23 x 8), each rank planning its slice: the
   ``kl_bound_indexed_`` counter zeroed before the plan and 23 launches a
   rank read after it, the gathered actions equal to rank 0's unsharded plan
   of every tree, both timed.

Rank 0 prints each card's ``nvidia-smi`` line, one JSON line of results
and, last, ``{"ok": true, "device": {...}}``; any rank's failure exits
non-zero.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_lines() -> list:
    """``nvidia-smi``'s name and power limit of every card."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()


def gathered(tensor, world: int):
    """Every rank's ``tensor`` concatenated along the leading axis."""
    import torch.distributed as dist

    parts = [torch.empty_like(tensor) for _ in range(world)]
    dist.all_gather(parts, tensor.contiguous())
    return torch.cat(parts)


def check_learner(cs, rank, world, dev, mesh) -> dict:
    import torch.distributed as dist

    from rl_agents_torch.models.optimizers import optimizer_factory
    from rl_agents_torch.parallel.actor_learner import make_sharded_actor_learner

    S = cs.SHARDED["num_shards"]
    lo, hi = rank * S // world, (rank + 1) * S // world
    results = {}
    for name in ("cartpole", "highway"):
        env, model, reset0, draws = cs.sharded_case(name)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        steps = cs.SHARDED_STEPS[name]

        def rows(tree, axis):
            if tree is None or isinstance(tree, torch.Tensor):
                return None if tree is None else tree.narrow(axis, lo, hi - lo)
            return type(tree)(rows(x, axis) for x in tree)

        init_fn, segment_fn, _ = make_sharded_actor_learner(
            env, copy.deepcopy(model), optimizer_factory("ADAM", lr=5e-4), mesh, device=dev,
            **cs.SHARDED)
        state = init_fn(torch.Generator(device=dev).manual_seed(rank), params=params,
                        reset_noise=cs.to_device(rows(reset0, 0), dev))
        local_draws = type(draws)(*(cs.to_device(rows(x, 1), dev) if x is not None else None
                                    for x in draws))
        segment_fn(state, steps=steps, draws=local_draws)
        buffer = {f: gathered(getattr(state.buffer, f), world).cpu()
                  for f in ("action", "terminal", "reward")}
        ok = torch.ones((), device=dev)
        if rank == 0:
            ref_init, ref_segment, _ = make_sharded_actor_learner(
                env, copy.deepcopy(model), optimizer_factory("ADAM", lr=5e-4), None,
                device="cpu", **cs.SHARDED)
            ref = ref_init(torch.Generator().manual_seed(0), params=params, reset_noise=reset0)
            ref_segment(ref, steps=steps, draws=draws)
            same = all(torch.equal(buffer[f], getattr(ref.buffer, f))
                       for f in ("action", "terminal"))
            reward_err = float((buffer["reward"] - ref.buffer.reward).abs().max())
            counters = [int(getattr(s, f)) for s in (state, ref)
                        for f in ("position", "size", "time", "completed_count")]
            ok.fill_(float(same and counters[:4] == counters[4:]
                           and reward_err <= cs.SHARDED_REWARD_TOLERANCE[name]))
            reference = {k: v.to(dev) for k, v in ref.params.items()}
        else:
            reference = {k: torch.empty_like(v) for k, v in state.params.items()}
            reward_err = 0.0
        for value in reference.values():
            dist.broadcast(value, src=0)
        worst = max(float((state.params[k] - reference[k]).abs().max()) for k in reference)
        errors = torch.tensor([worst], device=dev)
        dist.all_reduce(errors, op=dist.ReduceOp.MAX)
        dist.broadcast(ok, src=0)
        if not bool(ok) or float(errors) > cs.MODEL_TOLERANCE:
            raise AssertionError(f"sharded learner ({name}) over {world} ranks: rings or "
                                 f"counters differ from the CPU program, or parameters "
                                 f"{float(errors)!r} apart")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        started = time.time()
        segment_fn(state, steps=steps)  # a second segment, draws from each rank's generator
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.time() - started) / steps * 1e3
        profiled = cs.nccl_kernels(lambda: segment_fn(state, steps=1, draws=cs.first_step(
            local_draws))) if dev.type == "cuda" else {}
        results[name] = {"ms_per_step": ms, "param_err": float(errors), "reward_err": reward_err,
                         "shards_per_rank": hi - lo, **profiled}
    return results


def check_planner(cs, rank, world, dev, mesh) -> dict:
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch
    from rl_agents_torch.ops.kl_bound import kl_bound_indexed_
    from rl_agents_torch.parallel.mesh import sharded_planner_batch

    env, params, states = cs.cartpole_case(dev)
    kw = dict(num_actions=2, episodes=cs.EPISODES, horizon=cs.HORIZON, gamma=cs.GAMMA,
              threshold_coeff=4.0)
    states0 = states(dev, cs.TREES)
    plan = lambda: sharded_planner_batch(
        mesh, lambda p, s, n: olop_plan_batch(env, p, s, device=dev, **kw)[:2], params, states0)
    plan()  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kl_bound_indexed_.launches = 0
    started = time.time()
    actions, _ = plan()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sharded_ms = (time.time() - started) * 1e3
    launches = kl_bound_indexed_.launches
    result = {"sharded_ms": sharded_ms, "kl_bound_indexed_launches_per_rank": launches}
    if rank == 0:
        started = time.time()
        whole, _, _ = olop_plan_batch(env, params, states0, device=dev, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result["unsharded_ms"] = (time.time() - started) * 1e3
        if not torch.equal(actions, whole):
            raise AssertionError("sharded planner batch: actions differ from the unsharded plan")
    if dev.type == "cuda" and launches != cs.EPISODES:
        raise AssertionError(f"sharded planner batch: {launches} kl_bound_indexed_ launches on "
                             f"rank {rank}, expected {cs.EPISODES}")
    return result


def run_rank(rank: int, world: int, port: int, device: str, trees: int):
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    import chip_smoke as cs
    from rl_agents_torch.parallel.distributed import make_pod_mesh, maybe_initialize_distributed

    cs.TREES = trees
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    if device == "cpu":  # a gloo group even where cards are present
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        dev = torch.device("cpu")
    else:
        maybe_initialize_distributed(f"localhost:{port}", world, rank)
        dev = torch.device("cuda", rank)
    import torch.distributed as dist

    try:
        mesh = make_pod_mesh(axes=("host", "dp"))
        learner = check_learner(cs, rank, world, dev, mesh)
        planner = check_planner(cs, rank, world, dev, mesh)
        if rank == 0:
            print(json.dumps({"ranks": world, "backend": dist.get_backend(),
                              "sharded_learner": learner, "sharded_planner_batch": planner}),
                  flush=True)
    finally:
        dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=None,
                        help="processes (default: one per visible card)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--trees", type=int, default=4096, help="trees of the planner batch")
    args = parser.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("multichip_smoke: no CUDA device; pass --device cpu for gloo")
        ranks = args.ranks or torch.cuda.device_count()
        if ranks > torch.cuda.device_count():
            raise SystemExit(f"multichip_smoke: {ranks} ranks, {torch.cuda.device_count()} cards")
        sys.path.insert(0, str(REPO))
        import chip_smoke as cs
        from rl_agents_torch.ops import kl_bound as kl_module

        for line in card_lines():
            print(line)
        kl_module.build()  # once, before the ranks load it
    else:
        ranks = args.ranks or 2
    started = time.time()
    torch.multiprocessing.spawn(run_rank, args=(ranks, free_port(), args.device, args.trees),
                                nprocs=ranks, join=True)
    print(f"{ranks} ranks in {time.time() - started!r} s")
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": torch.cuda.device_count() if args.device == "cuda" else 0}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
