"""Traffic of kind ``agent_loop``: one agent in a closed loop, as a user's
evaluation runs it: ``agent.act(observation)``, then the env handle's
``step``, episodes until a crash or the env's duration, for the whole
window.

Set-up goes through the program's ``load_environment`` and ``load_agent``
on the card, draws a pool of scenes from the seed on the device, and warms
up with a few steps of an extra scene. Each episode starts from the next
scene of the pool: the env's own reset gets the benchmark's draws (the
reference resets from the same draws), the agent is seeded and reset as
``Evaluation.reset`` does. A step's time runs from the start of its act
(of its episode's reset, for an episode's first step) to the end of the
env's step; both end by reading their result on the host.

The comparison covers every step of the window. At each, the reference
plans from the state the program's env was in, and the action the agent
took is held to the best action's value by the gap between them (the
agent breaks exact ties with its own draws, so any of equal value is
right); the reference steps that state with that action and its next
state and reward are held to the program's. Each episode's first state is
held to the reference's reset from the same draws.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.pbcore import draws as draw
from perfbench.pbcore import profiling
from perfbench.pbcore.compare import checked, gap


class Loop:
    def __init__(self, ctx, program=None):
        self.ctx = ctx
        self.program = program  # program(loop) -> (act, step) in the agent's and env's place

    def setup(self):
        from rl_agents_torch.factory import load_agent, load_environment

        ctx = self.ctx
        self.handle = load_environment(dict(ctx.config["env"]), device=ctx.device)
        self.agent = load_agent(dict(ctx.config["agent"]), self.handle, device=ctx.device)
        pool = int(ctx.traffic["scene_pool"])
        gen = draw.generator(ctx.seed, draw.SCENES, 0, ctx.device)
        self.pool = ctx.env.scene_draws(gen, pool + 1, ctx.model)
        self.act, self.step = self.program(self) if self.program \
            else (self.agent.act, self.handle.step)
        self.episodes, self.records = [], []

    def warm_up(self):
        """A few steps on the pool's extra scene."""
        ctx = self.ctx
        pool = int(ctx.traffic["scene_pool"])
        self._episode(pool)
        for _ in range(int(ctx.traffic["warmup_steps"])):
            obs, _, done, truncated, _ = self.step(self.act(self.obs))
            self.obs = obs
            if done or truncated:
                self._episode(pool)
        profiling.synchronize(ctx.device)

    def _episode(self, index: int):
        """Start an episode from scene ``index`` of the pool."""
        handle = self.handle
        scene = tuple(x[index:index + 1] for x in self.pool)
        handle.state, handle.obs = handle.functional.reset(handle.params, handle.generator, 1,
                                                           noise=scene)
        self.obs = handle.obs[0].cpu().numpy()
        seed = draw.stream_seed(self.ctx.seed, draw.EPISODE, index)
        self.agent.seed(seed)
        self.agent.reset()

    def _run(self, seconds: float, spans: dict):
        """Steps until ``seconds`` have passed; returns each step's seconds and
        the window's."""
        step_seconds = []
        started = time.perf_counter()
        fresh = True
        while True:
            t0 = time.perf_counter()
            if fresh:
                index = len(self.episodes)
                self._episode(index)
                self.episodes.append((index, self.handle.state))
            before = self.handle.state
            t1 = time.perf_counter()
            action = self.act(self.obs)
            t2 = time.perf_counter()
            self.obs, reward, done, truncated, _ = self.step(action)
            t3 = time.perf_counter()
            self.records.append((before, int(action), reward, self.handle.state))
            step_seconds.append(t3 - t0)
            spans["agent.act"].append(t2 - t1)
            spans["env.step"].append(t3 - t2)
            fresh = bool(done) or bool(truncated)
            if t3 - started >= seconds:
                return step_seconds, t3 - started

    def window(self, seconds: float) -> dict:
        self.spans = {"agent.act": [], "env.step": []}
        step_seconds, elapsed = self._run(seconds, self.spans)
        self.steps = len(step_seconds)
        return {"attempted": self.steps,
                "metrics": {"agent_step_ms": elapsed / self.steps * 1e3,
                            "agent_step_p95_ms": float(np.percentile(step_seconds, 95)) * 1e3},
                "spread": step_seconds}

    def trace(self) -> dict:
        ctx = self.ctx
        (steps,) = ctx.config["profile_units"]["agent_loop"]

        def some_steps():  # after the window: its records stay as they are
            for _ in range(int(steps)):
                obs, _, done, truncated, _ = self.step(self.act(self.obs))
                self.obs = obs
                if done or truncated:
                    self._episode(int(ctx.traffic["scene_pool"]))

        segment = profiling.profile("agent steps", some_steps, ctx.device, int(steps),
                                    int(steps))
        return {"segments": [segment], "spans": self.spans}

    def release(self):
        self.agent = self.handle = self.act = self.step = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, produced=None) -> dict:
        """The window's steps and episode starts against the reference.
        ``produced(model, states, actions, draws)`` gives the control's
        ``(actions, next states, rewards, starts)`` in the program's place."""
        ctx = self.ctx
        planner, config, env, model = ctx.planner, ctx.config, ctx.env, ctx.model
        befores = env.reference_states(torch.cat(x) for x in zip(*(r[0] for r in self.records)))
        actions = torch.tensor([r[1] for r in self.records], device=befores.x.device)
        rewards = torch.tensor([r[2] for r in self.records], dtype=torch.float32,
                               device=befores.x.device)
        afters = env.reference_states(torch.cat(x) for x in zip(*(r[3] for r in self.records)))
        scenes = [tuple(x[i:i + 1] for x in self.pool) for i, _ in self.episodes]
        starts = [env.reference_states(s) for _, s in self.episodes]
        if produced is not None:
            actions, afters, rewards, starts = produced(befores, scenes)

        values = planner.action_values(config, env, model, befores)
        chosen = values.gather(1, actions.to(values.device)[:, None]).squeeze(1)
        action_gap = float((values.amax(dim=1) - chosen).max())
        want, want_reward, _ = env.transition(model, befores, actions)
        state_gap = max(gap(a, b) for a, b in zip(afters, want))
        for start, drawn in zip(starts, scenes):  # each reset is its own [1, V] call
            state_gap = max(state_gap, max(gap(a, b) for a, b in
                                           zip(start, env.reset(model, drawn))))
        return checked({"action_gap": action_gap if action_gap == action_gap else 1e300,
                        "state_gap": state_gap, "reward_gap": gap(rewards, want_reward)},
                       config["limits"]["agent_loop"])

    def control(self, dtype, seconds: float) -> dict:
        """The control: the reference computed in ``dtype`` in the program's
        place at every state of a short window of the program's own loop:
        its first action by its own values (the first of equals), its next
        state and reward from that action, each episode's start from the
        same draws; judged as a run is."""
        self.setup()
        self.warm_up()
        self.window(seconds)
        self.release()
        ctx = self.ctx
        env, model = ctx.env, ctx.model

        def produced(befores, scenes):
            low = type(befores)(*(x.to(dtype) if x.is_floating_point() else x for x in befores))
            picked = ctx.planner.action_values(ctx.config, env, model, low,
                                               dtype=dtype).argmax(dim=1)
            after, reward, _ = env.transition(model, low, picked, dtype)
            starts = [env.reset(model, drawn, dtype=dtype) for drawn in scenes]
            return picked, after, reward, starts

        return self.check(produced)
