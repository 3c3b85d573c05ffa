"""Traffic of kind ``batch_plan``: one batch planner over ``trees`` seeded
scenes, plans back to back.

Set-up builds the env through the program's ``load_environment``, draws the
scenes from the seed on the device and hands the draws to the env's own
reset (the reference resets from the same draws), and warms up with whole
plans. The window runs plans until ``--seconds`` have passed, each with
fresh draws from the seed and a synchronise at its end; a plan begun in the
window is finished and counted, and the window closes with it. One plan,
drawn from the seed among those completed (reservoir sampling), is kept
and compared with the reference, tree by tree.
"""
from __future__ import annotations

import time

import torch

from perfbench.pbcore import draws as draw
from perfbench.pbcore import profiling
from perfbench.pbcore.compare import batch_checks


class Loop:
    def __init__(self, ctx, program=None):
        self.ctx = ctx
        self.program = program or ctx.planner.program_plan
        self.trees = int(ctx.traffic["trees"])

    def _draws(self, index: int) -> dict:
        gen = draw.generator(self.ctx.seed, draw.PLAN, index, self.ctx.device)
        return self.ctx.planner.plan_draws(self.ctx.config, self.trees, gen)

    def _plan(self, drawn: dict, units_run=None) -> dict:
        return self.program(self.ctx.config, self.env, self.params, self.states0, drawn,
                            self.ctx.device, units_run)

    def setup(self):
        from rl_agents_torch.factory import load_environment

        ctx = self.ctx
        handle = load_environment(dict(ctx.config["env"]), device=ctx.device)
        self.env, self.params = handle.functional, handle.params
        gen = draw.generator(ctx.seed, draw.SCENES, 0, ctx.device)
        self.scene_draws = ctx.env.scene_draws(gen, self.trees, ctx.model)
        self.states0, _ = self.env.reset(self.params, gen, self.trees, noise=self.scene_draws)

    def warm_up(self):
        """Whole plans, so that every shape of the window's plans has run."""
        ctx = self.ctx
        for k in range(int(ctx.traffic["warmup_plans"])):
            gen = draw.generator(ctx.seed, draw.WARMUP, k, ctx.device)
            self._plan(ctx.planner.plan_draws(ctx.config, self.trees, gen))
        profiling.synchronize(ctx.device)

    def window(self, seconds: float) -> dict:
        ctx = self.ctx
        pick = draw.host_rng(ctx.seed, draw.SAMPLE)
        self.plan_seconds, self.kept = [], None
        started = last = time.perf_counter()
        while True:
            index = len(self.plan_seconds)
            out = self._plan(self._draws(index))
            profiling.synchronize(ctx.device)
            now = time.perf_counter()
            self.plan_seconds.append(now - last)
            last = now
            if pick.random() < 1.0 / (index + 1):
                self.kept = (index, out)
            del out
            if now - started >= seconds:
                break
        elapsed = last - started
        plans = len(self.plan_seconds)
        rate = plans * ctx.planner.work(ctx.config, self.trees) / elapsed
        return {"attempted": plans, "metrics": {"plan_rate": rate},
                "spread": self.plan_seconds}

    def trace(self) -> dict:
        ctx = self.ctx
        planner, config = ctx.planner, ctx.config
        full = planner.units(config)
        drawn = self._draws(0)
        # the transition is timed before the profiler has run in this process
        rows, actions = planner.transition_rows(config, self.states0, drawn)
        calls = int(ctx.traffic["transition_calls"])
        self.env.transition(self.params, rows, actions)  # its rows' first call
        transition_s = time_calls(lambda: self.env.transition(self.params, rows, actions), calls,
                                  ctx.device)
        segments = []
        for units_run in ctx.config["profile_units"]["batch_plan"]:
            units_run = min(int(units_run), full)
            segments.append(profiling.profile(
                "plan", lambda: self._plan(drawn, None if units_run == full else units_run),
                ctx.device, units_run, full))
        ops, nbytes = planner.plan_counts(config, self.trees)
        return {"segments": segments,
                "spans": {"env.transition": [transition_s]},
                "plan": {"seconds": self.plan_seconds, "ops": ops, "bytes": nbytes},
                "kernels": planner.kernel_counts(config, self.trees)}

    def release(self):
        """Free the program's state but the kept plan's output."""
        self.env = self.params = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, produced=None) -> dict:
        """Compare the kept plan (or ``produced``, the control's output on its
        inputs) with the reference's plan on the same inputs."""
        ctx = self.ctx
        planner, config = ctx.planner, ctx.config
        env, model = ctx.env, ctx.model
        index, out = self.kept
        drawn = self._draws(index)
        scenes = env.reset(model, self.scene_draws)
        want = planner.reference_plan(config, env, model, scenes, drawn)
        if produced is not None:
            out = produced(self.scene_draws, drawn)
        self.kept = None
        return batch_checks(planner, out, want, config["limits"]["batch_plan"])

    def control(self, dtype, seconds: float = 0.0) -> dict:
        """The control: the reference computed in ``dtype`` in the program's
        place, on a plan's inputs from the seed, judged as a run is."""
        ctx = self.ctx
        env, model = ctx.env, ctx.model
        gen = draw.generator(ctx.seed, draw.SCENES, 0, ctx.device)
        self.scene_draws = env.scene_draws(gen, self.trees, model)
        self.kept = (0, None)

        def produced(scene_draws, drawn):
            scenes = env.reset(model, scene_draws, dtype=dtype)
            return ctx.planner.reference_plan(ctx.config, env, model, scenes, drawn, dtype=dtype)

        return self.check(produced)


def time_calls(run, calls: int, device) -> float:
    """Mean seconds of a call over a block of ``calls`` calls, by CUDA events
    (by the host's clock where there is no card)."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            run()
        end.record()
        torch.cuda.synchronize(device)
        mean = start.elapsed_time(end) / 1e3 / calls
    else:
        started = time.perf_counter()
        for _ in range(calls):
            run()
        mean = (time.perf_counter() - started) / calls
    return mean
