"""Fused on-device actor-learner for value-based training, on one device.

Port of ``rl_agents_tpu/parallel/actor_learner.py`` (``make_actor_learner``,
``train_dqn_fused``; the sharded learner is not ported). E envs act with
epsilon-greedy Q-policies, write their transitions into a device replay ring,
and a DQN update runs every step, with no read-back to the host inside a
segment. The semantics are the JAX package's:

- every env is reset each step, and the reset is kept only where done;
- an EMA of completed returns (0.95 / 0.05);
- the update runs every step and is discarded until the ring holds
  ``max(batch_size, learning_starts)`` rows;
- the target syncs when ``time % target_update == 0``;
- the loss is the squared error whatever the agent's ``loss_function``, as in
  JAX (``actor_learner.py:100-110``).

A segment's draws (the epsilon tests, the random actions, the env resets and
the minibatch indices) come up front from the state's ``torch.Generator`` on
the device, or are injected (``SegmentDraws``); a step is then a fixed
sequence of kernels. Step ``t`` of env ``e`` lands at ring row
``(t * E + e) % capacity``. On a CUDA device, for an env whose reset draw can
be made up front (``FunctionalEnv.reset_noise``: CartPole), one step is
captured in a ``torch.cuda.CUDAGraph`` and replayed; ``cuda_graph`` forces
either way.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from rl_agents_torch.agents.dqn.agent import clip_gradients_, loss_and_gradients, q_values
from rl_agents_torch.agents.dqn.replay import Batch, discounts, empty_batch, n_step_collapse
from rl_agents_torch.envs.base import FunctionalEnv
from rl_agents_torch.models.optimizers import (
    apply_updates,
    loss_function_factory,
    optimizer_factory,
)
from rl_agents_torch.models.zoo import init_parameters
from rl_agents_torch.utils.device import resolve_device


class ActorLearnerState(NamedTuple):
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: dict
    buffer: Batch              # capacity-C device replay ring
    position: torch.Tensor     # [] i64
    size: torch.Tensor         # [] i64
    env_states: Any            # E-batched env states
    obs: torch.Tensor          # [E, ...]
    episode_return: torch.Tensor   # [E] running returns
    completed_return: torch.Tensor  # [] EMA of completed episode returns
    completed_count: torch.Tensor   # [] i64
    time: torch.Tensor         # [] i64 exploration time
    generator: torch.Generator


class SegmentDraws(NamedTuple):
    """Every random input of K steps, drawn up front or injected."""
    explore: torch.Tensor          # [K, E] f32 uniforms, explore where < epsilon
    random_actions: torch.Tensor   # [K, E] i64
    reset: Optional[Any]           # [K, E, ...] the env's reset noise; None: drawn in reset
    sample: torch.Tensor           # [K, U, n] i64 indices, or f32 uniforms in [0, 1)


def _tree_copy_(dst, src):
    """Copy a nest (dict / list / NamedTuple / tensor) of tensors into ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _tree_copy_(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _tree_copy_(d, s)


def _tree_clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree


def _tree_where(cond, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    if isinstance(new, dict):
        return {k: _tree_where(cond, new[k], old[k]) for k in new}
    return type(new)(_tree_where(cond, n, o) for n, o in zip(new, old))


def _row(tensor, t):
    """``tensor[t]`` for a device index ``t`` ([1] i64), without a read-back."""
    return tensor.index_select(0, t).squeeze(0)


def make_actor_learner(env: FunctionalEnv, model, optimizer,
                       num_envs: int = 16, capacity: int = 50_000,
                       batch_size: int = 100, gamma: float = 0.99,
                       double: bool = True, target_update: int = 1,
                       eps_init: float = 1.0, eps_final: float = 0.1,
                       eps_tau: float = 5000.0, learning_starts: int = 200,
                       n_steps: int = 1, updates_per_step: int = 1,
                       sample_mode: str = "uniform", cuda_graph: Optional[bool] = None,
                       device="cuda"):
    """Build ``(init_fn, segment_fn)``: ``init_fn(generator, params=None,
    reset_noise=None, env_params=None)`` makes the state (fresh parameters
    drawn from ``generator`` unless given, E envs reset), and
    ``segment_fn(state, steps, draws=None)`` runs ``steps`` fused steps in
    place and returns ``(state, mean reward)``.

    ``n_steps > 1`` collapses n consecutive same-env transitions per sample
    (stride E in the interleaved ring). ``updates_per_step > 1`` runs that
    many SGD updates, each on its own minibatch, per env step.
    ``sample_mode="slices"`` (needs ``batch_size % num_envs == 0``,
    ``capacity % num_envs == 0`` and ``n_steps == 1``) samples
    ``batch_size / E`` whole time-slices of the ring instead of rows.
    ``cuda_graph`` captures one step in a CUDA graph and replays it; by
    default it does so on a CUDA device for an env whose reset draw can be
    made up front."""
    device = resolve_device(device)
    model = model.to(device)
    E = num_envs
    if sample_mode not in ("uniform", "slices"):
        raise ValueError(f"Unknown sample_mode {sample_mode}")
    if sample_mode == "slices" and (batch_size % E != 0 or n_steps != 1
                                    or capacity % E != 0):
        # a misaligned ring wraps writes mid-block, so an E-aligned read
        # would mix two write steps (same env twice) and bias the tail rows
        raise ValueError("slices sampling needs batch_size % num_envs == 0, "
                         "capacity % num_envs == 0 and n_steps == 1")
    obs_shape = tuple(env.observation_space.shape)
    num_actions = env.action_space.n
    per_update = batch_size // E if sample_mode == "slices" else batch_size
    lanes = torch.arange(E, device=device)
    discount = discounts(gamma, n_steps, device)
    threshold = max(batch_size, learning_starts)
    holder: Dict[str, Any] = {}

    def init_fn(generator: torch.Generator, params=None, reset_noise=None, env_params=None):
        env_params = env.default_params(device) if env_params is None else env_params
        holder["env_params"] = env_params
        if params is None:
            init_parameters(model, generator)
            params = {k: p.detach() for k, p in model.named_parameters()}
        params = {k: v.detach().to(device).clone() for k, v in params.items()}
        values = list(params.values())
        if reset_noise is None:
            env_states, obs = env.reset(env_params, generator, E)
        else:
            env_states, obs = env.reset(env_params, generator, E, noise=reset_noise)
        zero_i = torch.zeros((), dtype=torch.int64, device=device)
        return ActorLearnerState(
            params=params, target_params={k: v.clone() for k, v in params.items()},
            opt_state=optimizer.init(values),
            buffer=empty_batch(capacity, obs_shape, device),
            position=zero_i.clone(), size=zero_i.clone(),
            env_states=env_states, obs=obs.float(),
            episode_return=torch.zeros(E, device=device),
            completed_return=torch.zeros((), device=device),
            completed_count=zero_i.clone(), time=zero_i.clone(), generator=generator)

    def draw_segment(state: ActorLearnerState, steps: int) -> SegmentDraws:
        g = state.generator
        explore = torch.rand((steps, E), generator=g, device=device)
        random_actions = torch.randint(0, num_actions, (steps, E), generator=g, device=device)
        reset = env.reset_noise(holder["env_params"], g, steps * E)
        if reset is not None:
            reset = reset.reshape((steps, E) + tuple(reset.shape[1:]))
        sample = torch.rand((steps, updates_per_step, per_update), generator=g, device=device)
        return SegmentDraws(explore, random_actions, reset, sample)

    squared_error = loss_function_factory("l2")

    def grad_update(params, opt_state, target_params, minibatch):
        _, grads = loss_and_gradients(model, squared_error, params, target_params, minibatch,
                                      gamma, double)
        clip_gradients_(grads)
        values = list(params.values())
        updates, opt_state = optimizer.update(grads, opt_state, values)
        return dict(zip(params, apply_updates(values, updates))), opt_state

    def sample_minibatch(buffer: Batch, size, draw):
        if draw.is_floating_point():
            avail = torch.clamp(size // E if sample_mode == "slices" else size, min=1)
            draw = torch.minimum((draw * avail).long(), avail - 1)
        if sample_mode == "slices":
            idx = (draw[:, None] * E + lanes[None, :]).reshape(-1)
            return Batch(*(x[idx] for x in buffer))
        if n_steps == 1:
            return Batch(*(x[draw] for x in buffer))
        return n_step_collapse(buffer, draw, torch.clamp(size, min=1), n_steps, gamma,
                               stride=E, discount=discount)

    def one_step(state: ActorLearnerState, explore, random_actions, reset, sample):
        env_params = holder["env_params"]
        # ---- act: epsilon-greedy over Q --------------------------------
        eps = eps_final + (eps_init - eps_final) * torch.exp(-state.time.float() / eps_tau)
        with torch.no_grad():
            greedy = q_values(model, state.params, state.obs).argmax(dim=1)
        actions = torch.where(explore < eps, random_actions, greedy)

        # ---- env step, auto-reset --------------------------------------
        outs = env.step(env_params, state.env_states, actions, state.generator)
        done = outs.terminated | outs.truncated
        if reset is None:
            reset_states, reset_obs = env.reset(env_params, state.generator, E)
        else:
            reset_states, reset_obs = env.reset(env_params, state.generator, E, noise=reset)

        def keep(new, fresh):
            return torch.where(done.reshape((E,) + (1,) * (new.dim() - 1)), fresh, new)

        env_states = type(outs.state)(*(keep(n, r) for n, r in zip(outs.state, reset_states)))
        next_obs = keep(outs.obs, reset_obs).float()

        # episode-return bookkeeping
        episode_return = state.episode_return + outs.reward
        finished = done.sum()
        mean_finished = torch.where(done, episode_return, 0.0).sum() / torch.clamp(finished, min=1)
        completed_return = torch.where(
            finished > 0, 0.95 * state.completed_return + 0.05 * mean_finished,
            state.completed_return)
        episode_return = torch.where(done, 0.0, episode_return)

        # ---- replay write (E rows) -------------------------------------
        rows = (state.position + lanes) % capacity
        buf = state.buffer
        buf.state.index_copy_(0, rows, state.obs)
        buf.action.index_copy_(0, rows, actions)
        buf.reward.index_copy_(0, rows, outs.reward.float())
        buf.next_state.index_copy_(0, rows, outs.obs.float())
        buf.terminal.index_copy_(0, rows, outs.terminated)
        size = torch.clamp(state.size + E, max=capacity)

        # ---- learner update(s) -----------------------------------------
        minibatches = [sample_minibatch(buf, size, sample[u]) for u in range(updates_per_step)]
        params, opt_state = state.params, state.opt_state
        for minibatch in minibatches:
            params, opt_state = grad_update(params, opt_state, state.target_params, minibatch)
        can_train = size >= threshold
        params = _tree_where(can_train, params, state.params)
        opt_state = _tree_where(can_train, opt_state, state.opt_state)
        time = state.time + 1
        target_params = _tree_where(time % target_update == 0, params, state.target_params)

        # ---- commit in place -------------------------------------------
        _tree_copy_(state.params, params)
        _tree_copy_(state.opt_state, opt_state)
        _tree_copy_(state.target_params, target_params)
        _tree_copy_(state.env_states, env_states)
        state.obs.copy_(next_obs)
        state.episode_return.copy_(episode_return)
        state.completed_return.copy_(completed_return)
        state.completed_count.add_(finished)
        state.position.copy_((state.position + E) % capacity)
        state.size.copy_(size)
        state.time.copy_(time)
        return outs.reward.float().mean()

    def run_eager(state, draws, steps):
        rewards = []
        for t in range(steps):
            reset = None if draws.reset is None else draws.reset[t]
            rewards.append(one_step(state, draws.explore[t], draws.random_actions[t], reset,
                                    draws.sample[t]))
        return torch.stack(rewards).mean()

    def run_graph(state, draws, steps):
        graph = holder.get("graph")
        if graph is None or holder["graph_state"] is not state \
                or holder["draws"].explore.shape[0] < steps:
            _capture(state, draws, steps)
        static = holder["draws"]
        for field, value in zip(static, draws):
            field[:steps].copy_(value)
        holder["t"].zero_()
        for _ in range(steps):
            holder["graph"].replay()
        return holder["rewards"][:steps].mean()

    def _capture(state, draws, steps):
        if draws.reset is None:
            raise ValueError("cuda_graph=True needs an env whose reset draw is made up front "
                             "(FunctionalEnv.reset_noise)")
        static = SegmentDraws(*(_tree_clone(d) for d in draws))
        t = torch.zeros(1, dtype=torch.int64, device=device)
        rewards = torch.zeros(steps, device=device)

        def step(target):
            reward = one_step(target, _row(static.explore, t), _row(static.random_actions, t),
                              _row(static.reset, t), _row(static.sample, t))
            rewards.index_copy_(0, t, reward.reshape(1))
            t.add_(1)

        # warm up on a throwaway copy of the state, on a side stream
        scratch = ActorLearnerState(*(_tree_clone(v) for v in state[:-1]),
                                    generator=state.generator)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):
                step(scratch)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(state)
        holder.update(graph=graph, graph_state=state, draws=static, t=t, rewards=rewards)

    def segment_fn(state: ActorLearnerState, steps: int = 100,
                   draws: Optional[SegmentDraws] = None):
        if draws is None:
            draws = draw_segment(state, steps)
        graph = cuda_graph
        if graph is None:
            graph = device.type == "cuda" and draws.reset is not None
        if graph:
            return state, run_graph(state, draws, steps)
        return state, run_eager(state, draws, steps)

    return init_fn, segment_fn


def train_dqn_fused(env: FunctionalEnv, model, total_steps: int = 5000,
                    segment: int = 250, seed: int = 0, lr: float = 5e-4,
                    writer=None, device="cuda", **kwargs):
    """Fused DQN training to a step budget with ADAM; returns the final
    ``ActorLearnerState`` and the history of EMA episode returns."""
    device = resolve_device(device)
    optimizer = optimizer_factory("ADAM", lr=lr)
    init_fn, segment_fn = make_actor_learner(env, model, optimizer, device=device, **kwargs)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = init_fn(generator)
    history = []
    for i in range(total_steps // segment):
        state, _ = segment_fn(state, steps=segment)
        ema = float(state.completed_return)
        history.append(ema)
        if writer is not None:
            writer.add_scalar("episode/ema_return", ema, i * segment)
    return state, history
