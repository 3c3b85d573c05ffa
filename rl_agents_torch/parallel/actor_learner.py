"""Fused on-device actor-learner for value-based training.

Port of ``rl_agents_tpu/parallel/actor_learner.py``: ``make_actor_learner``
and ``train_dqn_fused`` on one device, and ``make_sharded_actor_learner``
over the ranks of a ``torch.distributed`` mesh. E envs act with
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
from torch.distributed.tensor import DTensor, Replicate, Shard

from rl_agents_torch.agents.dqn.agent import clip_gradients_, loss_and_gradients, q_values
from rl_agents_torch.agents.dqn.replay import Batch, discounts, empty_batch, n_step_collapse
from rl_agents_torch.envs.base import FunctionalEnv
from rl_agents_torch.models.optimizers import (
    apply_updates,
    loss_function_factory,
    optimizer_factory,
)
from rl_agents_torch.models.zoo import init_parameters
from rl_agents_torch.parallel.mesh import DataParallel, clip_, dqn_loss
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
            # owned copies: a reset may return views of the caller's reset noise,
            # and the segment writes the env states in place
            env_states=_tree_clone(env_states), obs=obs.float().clone(),
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


class ShardedActorLearnerState(NamedTuple):
    """This rank's part of the fused train state over ``S`` shards.

    Each shard owns E envs, a replay ring and its draws, so the program's
    math does not depend on how many ranks hold the shards: a run on one
    rank and a run on several differ only in the order of their sums. The
    parameters are replicated over the data ranks (DTensors sharded over
    ``tp`` when tensor-parallel); the rows are this rank's ``S_l = S / n``
    shards."""
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: dict            # over the local shards of the parameters
    buffer: Batch              # [S_l, C, ...] this rank's replay rings
    position: torch.Tensor     # [] i64, the same in every shard
    size: torch.Tensor         # [] i64
    env_states: Any            # S_l * E envs, shard-major along the batch
    obs: torch.Tensor          # [S_l, E, *obs]
    episode_return: torch.Tensor    # [S_l, E]
    completed_return: torch.Tensor  # [] EMA over every rank's finished episodes
    completed_count: torch.Tensor   # [] i64, over every rank
    time: torch.Tensor         # [] i64
    generator: torch.Generator  # this rank's draws


def _flatten_rows(tree, rows: int):
    """Merge the two leading axes (shard, env) of every tensor of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.reshape((rows,) + tuple(tree.shape[2:]))
    return type(tree)(_flatten_rows(t, rows) for t in tree)


def _tree_index(tree, t: int):
    """Step ``t`` of a segment's draw (a tensor, a tuple of them, or None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[t]
    return type(tree)(_tree_index(x, t) for x in tree)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def make_sharded_actor_learner(env: FunctionalEnv, model, optimizer, mesh=None,
                               num_shards: int | None = None, envs_per_shard: int = 8,
                               capacity: int = 6_250, batch_size: int = 16,
                               gamma: float = 0.99, double: bool = True,
                               target_update: int = 1, eps_init: float = 1.0,
                               eps_final: float = 0.1, eps_tau: float = 5000.0,
                               learning_starts: int = 32, tp: bool = False,
                               n_steps: int = 1, device="cuda"):
    """Fused actor-learner over a ``torch.distributed`` mesh's data axes.

    ``S = num_shards`` shards (default: one per data rank) of ``E =
    envs_per_shard`` envs each, with rings ``[S, C]``; each data rank holds
    ``S / n`` of them. ``capacity``, ``batch_size`` and ``envs_per_shard``
    are per shard: each shard samples ``batch_size`` rows of its own ring,
    and the loss is the mean over the ``S * B`` rows (local sums, an
    ``all_reduce`` of the gradients, then a division by ``S * B``). The
    gradients are clipped to [-1, 1] after the reduce, as JAX clips the
    global gradient, and the completed-return EMA is built from global
    sums. The ring write is an ``index_copy_`` at ``(position + e) % C``,
    the same rows as JAX's aligned write when ``C % E == 0``; ``n_steps >
    1`` collapses transitions with ``n_step_collapse(stride=E)``.

    ``mesh`` is a ``DeviceMesh`` (``make_pod_mesh``, ``make_mesh``); with a
    process group initialized the collectives run, at world size 1 too, and
    with ``tp`` the parameters shard over the mesh's ``tp`` axis. Without a
    mesh it is the one-rank program.

    Returns ``(init_fn, segment_fn, shardings_fn)``: ``init_fn(generator,
    params=None, reset_noise=None, env_params=None)`` makes this rank's state
    (rank 0's parameters broadcast; ``reset_noise`` ``[S_l, E, ...]``);
    ``segment_fn(state, steps, draws=None)`` runs ``steps`` steps in place,
    with draws from this rank's generator or injected as a ``SegmentDraws``
    with a shard axis (``[K, S_l, E]``, ``[K, S_l, E, ...]``, ``[K, S_l,
    B]``), and returns ``(state, mean reward over every env and step)``;
    ``shardings_fn(state)`` gives each leaf's placement for the checkpoint
    store: ``Shard(0)`` for this rank's rows and generator, ``Replicate()``
    for the rest."""
    device = resolve_device(device)
    model = model.to(device)
    parallel = DataParallel(mesh, tp=tp)
    S = num_shards or parallel.count
    if S % parallel.count:
        raise ValueError(f"num_shards={S} must divide over {parallel.count} data ranks")
    S_l, E, C, B = S // parallel.count, envs_per_shard, capacity, batch_size
    rows = S_l * E
    obs_shape = tuple(env.observation_space.shape)
    num_actions = env.action_space.n
    lanes = torch.arange(E, device=device)
    shard_rows = torch.arange(S_l, device=device)[:, None]
    discount = discounts(gamma, n_steps, device)
    threshold = max(B, learning_starts)
    holder: Dict[str, Any] = {}

    def shardings_fn(state: ShardedActorLearnerState) -> ShardedActorLearnerState:
        rep, shard = Replicate(), Shard(0)
        return ShardedActorLearnerState(
            params=rep, target_params=rep, opt_state=rep, buffer=shard, position=rep,
            size=rep, env_states=shard, obs=shard, episode_return=shard,
            completed_return=rep, completed_count=rep, time=rep, generator=shard)

    def init_fn(generator: torch.Generator, params=None, reset_noise=None, env_params=None):
        env_params = env.default_params(device) if env_params is None else env_params
        holder["env_params"] = env_params
        if params is None:
            init_parameters(model, generator)
            params = {k: p.detach() for k, p in model.named_parameters()}
        params = parallel.place({k: v.detach().to(device).clone() for k, v in params.items()})
        if reset_noise is None:
            env_states, obs = env.reset(env_params, generator, rows)
        else:
            env_states, obs = env.reset(env_params, generator, rows,
                                        noise=_flatten_rows(reset_noise, rows))
        zero_i = torch.zeros((), dtype=torch.int64, device=device)
        ring = empty_batch(S_l * C, obs_shape, device)
        return ShardedActorLearnerState(
            params=params, target_params={k: v.clone() for k, v in params.items()},
            opt_state=optimizer.init([_local(v) for v in params.values()]),
            buffer=Batch(*(x.reshape((S_l, C) + tuple(x.shape[1:])) for x in ring)),
            position=zero_i.clone(), size=zero_i.clone(),
            env_states=_tree_clone(env_states),  # owned: see make_actor_learner's init_fn
            obs=obs.float().reshape((S_l, E) + obs_shape).clone(),
            episode_return=torch.zeros((S_l, E), device=device),
            completed_return=torch.zeros((), device=device),
            completed_count=zero_i.clone(), time=zero_i.clone(), generator=generator)

    def draw_segment(state: ShardedActorLearnerState, steps: int) -> SegmentDraws:
        g = state.generator
        explore = torch.rand((steps, S_l, E), generator=g, device=device)
        random_actions = torch.randint(0, num_actions, (steps, S_l, E), generator=g,
                                       device=device)
        reset = env.reset_noise(holder["env_params"], g, steps * rows)
        if reset is not None:
            reset = reset.reshape((steps, S_l, E) + tuple(reset.shape[1:]))
        sample = torch.rand((steps, S_l, B), generator=g, device=device)
        return SegmentDraws(explore, random_actions, reset, sample)

    def q_fn(params, x):
        return parallel.q_values(model, params, x)

    def sample_minibatch(buffer: Batch, size, draw) -> Batch:
        avail = torch.clamp(size, min=1)
        if draw.is_floating_point():
            draw = torch.minimum((draw * avail).long(), avail - 1)
        if n_steps == 1:
            picked = Batch(*(x[shard_rows, draw] for x in buffer))
            return Batch(*(x.reshape((S_l * B,) + tuple(x.shape[2:])) for x in picked))
        parts = [n_step_collapse(Batch(*(x[s] for x in buffer)), draw[s], avail, n_steps,
                                 gamma, stride=E, discount=discount) for s in range(S_l)]
        return Batch(*(torch.cat(field) for field in zip(*parts)))

    def one_step(state: ShardedActorLearnerState, explore, random_actions, reset, sample):
        env_params = holder["env_params"]
        # ---- act: epsilon-greedy over Q, per-shard draws -----------------
        eps = eps_final + (eps_init - eps_final) * torch.exp(-state.time.float() / eps_tau)
        with torch.no_grad():
            greedy = q_fn(state.params, state.obs.reshape((rows,) + obs_shape)).argmax(dim=1)
        actions = torch.where(explore < eps, random_actions, greedy.reshape(S_l, E))

        # ---- env step, auto-reset ----------------------------------------
        outs = env.step(env_params, state.env_states, actions.reshape(rows), state.generator)
        done = outs.terminated | outs.truncated
        if reset is None:
            reset_states, reset_obs = env.reset(env_params, state.generator, rows)
        else:
            reset_states, reset_obs = env.reset(env_params, state.generator, rows,
                                                noise=_flatten_rows(reset, rows))

        def keep(new, fresh):
            return torch.where(done.reshape((rows,) + (1,) * (new.dim() - 1)), fresh, new)

        env_states = type(outs.state)(*(keep(n, r) for n, r in zip(outs.state, reset_states)))
        next_obs = keep(outs.obs, reset_obs).float().reshape((S_l, E) + obs_shape)

        # ---- global episode-return bookkeeping (sums over every rank) -----
        reward = outs.reward.float().reshape(S_l, E)
        done = done.reshape(S_l, E)
        episode_return = state.episode_return + reward
        sums = parallel.all_reduce_(torch.stack([
            torch.where(done, episode_return, 0.0).sum(), done.sum().float(), reward.sum()]))
        finished = sums[1]
        completed_return = torch.where(
            finished > 0, 0.95 * state.completed_return
            + 0.05 * (sums[0] / torch.clamp(finished, min=1)), state.completed_return)
        episode_return = torch.where(done, 0.0, episode_return)

        # ---- per-shard replay write (E rows each) -------------------------
        write = (state.position + lanes) % C
        buf = state.buffer
        buf.state.index_copy_(1, write, state.obs)
        buf.action.index_copy_(1, write, actions)
        buf.reward.index_copy_(1, write, reward)
        buf.next_state.index_copy_(1, write, outs.obs.float().reshape((S_l, E) + obs_shape))
        buf.terminal.index_copy_(1, write, outs.terminated.reshape(S_l, E))
        size = torch.clamp(state.size + E, max=C)

        # ---- learner update: shard-local sampling, global gradient mean ---
        minibatch = sample_minibatch(buf, size, sample)
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss = dqn_loss(q_fn, leaves, state.target_params, minibatch, gamma, double, S * B)
        grads = clip_(parallel.reduce_gradients(parallel.gradients(loss, leaves)))
        params, opt_state = parallel.apply(optimizer, state.params, state.opt_state, grads)
        can_train = size >= threshold
        time = state.time + 1
        sync = time % target_update == 0

        # ---- commit in place (DTensors through their local shards) --------
        for name, old in state.params.items():
            kept = torch.where(can_train, _local(params[name]), _local(old))
            _local(old).copy_(kept)
            target = _local(state.target_params[name])
            target.copy_(torch.where(sync, kept, target))
        _tree_copy_(state.opt_state, _tree_where(can_train, opt_state, state.opt_state))
        _tree_copy_(state.env_states, env_states)
        state.obs.copy_(next_obs)
        state.episode_return.copy_(episode_return)
        state.completed_return.copy_(completed_return)
        state.completed_count.add_(finished.long())
        state.position.copy_((state.position + E) % C)
        state.size.copy_(size)
        state.time.copy_(time)
        return sums[2] / (S * E)

    def segment_fn(state: ShardedActorLearnerState, steps: int = 100,
                   draws: Optional[SegmentDraws] = None):
        if draws is None:
            draws = draw_segment(state, steps)
        rewards = [one_step(state, draws.explore[t], draws.random_actions[t],
                            _tree_index(draws.reset, t), draws.sample[t])
                   for t in range(steps)]
        return state, torch.stack(rewards).mean()

    return init_fn, segment_fn, shardings_fn


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
