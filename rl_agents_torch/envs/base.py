"""Functional environment core, batch-first.

Port of ``rl_agents_tpu/envs/base.py``. An environment is a pair of pure
functions over NamedTuples of tensors that carry a leading batch dimension:

    reset(params, generator, batch)                -> (state, obs)
    step(params, state, action, generator, noise)  -> StepOut

A stochastic ``step`` takes its randomness from ``noise`` when the caller
injects it, and draws it from ``generator`` otherwise.

The spaces sample from a ``torch.Generator`` or replay the JAX package's
draw from a raw threefry key (``utils/noise.py``). ``FunctionalEnv.rollout``,
``vector_step``, ``vector_reset`` and ``policy_rollout`` are the JAX
package's helpers over the batch-first envs: one batch step per time step,
each step's draws injected or taken from a generator.

"Forking" a simulation is carrying the state value, and one ``step`` over
``[B]`` states replaces the JAX package's ``vmap``. ``EnvHandle`` adapts the
pure core to the object-style harness/agent API (act/record loops, seeding
protocol) with a batch of one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device
from rl_agents_torch.utils.noise import threefry_randint, threefry_split, threefry_uniform


def _generator_device(generator: torch.Generator) -> torch.device:
    if generator is None:
        raise ValueError("a space's sample needs a generator or a key")
    return generator.device


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    def sample(self, generator: torch.Generator | None = None, key=None) -> torch.Tensor:
        """An action in ``[0, n)``: drawn from ``generator``, or JAX's
        ``randint(key, (), 0, n)`` for a raw threefry ``key``."""
        if key is not None:
            return torch.tensor(threefry_randint(key, self.n))
        return torch.randint(0, self.n, (), generator=generator,
                             device=_generator_device(generator))

    @property
    def shape(self):
        return ()


@dataclasses.dataclass(frozen=True)
class Box:
    low: Any
    high: Any
    shape: Tuple[int, ...]

    def sample(self, generator: torch.Generator | None = None, key=None) -> torch.Tensor:
        """A uniform point of the box, an infinite bound taken at +-1e3 as in
        the JAX package: drawn from ``generator``, or JAX's ``uniform`` for a
        raw threefry ``key``."""
        low = np.nan_to_num(np.asarray(self.low, np.float32), neginf=-1e3)
        high = np.nan_to_num(np.asarray(self.high, np.float32), posinf=1e3)
        if key is not None:
            return torch.tensor(threefry_uniform(key, self.shape, low, high))
        device = _generator_device(generator)
        u = torch.rand(self.shape, generator=generator, device=device)
        low, high = torch.tensor(low, device=device), torch.tensor(high, device=device)
        return torch.maximum(low, u * (high - low) + low)


@dataclasses.dataclass(frozen=True)
class TupleSpace:
    """One space per controlled agent (multi-agent actions and observations)."""
    spaces: Tuple[Any, ...]

    def sample(self, generator: torch.Generator | None = None, key=None) -> tuple:
        """One sample of each space: from ``generator`` in turn, or under the
        keys of JAX's ``split(key, len(spaces))``."""
        if key is not None:
            keys = threefry_split(key, len(self.spaces))
            return tuple(s.sample(key=k) for s, k in zip(self.spaces, keys))
        return tuple(s.sample(generator) for s in self.spaces)

    def __len__(self):
        return len(self.spaces)

    @property
    def shape(self):
        return (len(self.spaces),)


class StepOut(NamedTuple):
    """The single step signature of this framework, batch-first."""

    state: Any
    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: Dict[str, Any]

    @property
    def done(self):
        return self.terminated | self.truncated


def stack(items: list):
    """Stack a list of like values (tensors, NamedTuples or tuples of them,
    dicts of them) along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: stack([item[k] for item in items]) for k in first}
    if isinstance(first, tuple):
        fields = [stack(list(column)) for column in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return torch.as_tensor(np.asarray(items))


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    id: str
    max_episode_steps: int | None = None


def params_to(params, device: torch.device):
    """Move every tensor field of a params/state NamedTuple to ``device``."""
    return type(params)(*(torch.as_tensor(v).to(device) for v in params))


class FunctionalEnv:
    """Static environment definition: subclasses implement ``reset`` and
    ``step`` as pure tensor functions of a params NamedTuple; the instance
    holds only static structure (sizes, spaces)."""

    spec: EnvSpec = EnvSpec("functional-env")

    def default_params(self, device="cuda"):
        raise NotImplementedError

    def reset(self, params, generator: torch.Generator, batch: int = 1) -> Tuple[Any, Any]:
        raise NotImplementedError

    def reset_noise(self, params, generator: torch.Generator, batch: int = 1):
        """The random input of ``reset`` for ``batch`` states, for an env whose
        ``reset`` takes it as ``noise=``; None for an env that draws inside
        ``reset`` (the fused learner then cannot draw its resets up front)."""
        return None

    def step(self, params, state, action, generator: torch.Generator | None = None,
             noise=None) -> StepOut:
        """One transition of ``[B]`` states. ``noise`` is the env's own random
        input for the step (its shape and law are the env's); without it a
        stochastic env draws it from ``generator``."""
        raise NotImplementedError

    def observe(self, params, state):
        raise NotImplementedError

    def transition(self, params, state, action, generator: torch.Generator | None = None,
                   noise=None) -> StepOut:
        """Like ``step`` but exempt from producing a real observation:
        open-loop planners (OPD, MCTS rollouts) never read it, and an env with
        an expensive observation may override this to skip it. Default: the
        full step."""
        return self.step(params, state, action, generator, noise)

    def null_noise(self, batch: int, device):
        """The ``noise`` that the deterministic planners (OPD, GBOP-D) step
        the env with: they plan against one frozen outcome of every random
        draw, the one the JAX package's all-zero PRNG key gives. None for an
        env whose step is deterministic."""
        return None

    @property
    def action_space(self) -> Discrete | Box:
        raise NotImplementedError

    @property
    def observation_space(self) -> Discrete | Box:
        raise NotImplementedError

    def rollout(self, params, state, actions, generator: torch.Generator | None = None,
                noise=None) -> StepOut:
        """Step ``actions [T, B, ...]`` from ``state``, one batch step a time
        step; ``noise [T, B, ...]``, when given, is the env's own draw of each
        step (the JAX package splits one key a step). Returns the ``T`` steps'
        outputs stacked on a leading axis."""
        outs = []
        for t, action in enumerate(actions):
            out = self.step(params, state, action, generator, None if noise is None else noise[t])
            state = out.state
            outs.append(out)
        return stack(outs)

    def preprocess(self, name: str, args) -> "FunctionalEnv":
        """Named env preprocessors (reference: factory.py:97-116)."""
        raise ValueError(f"{type(self).__name__} has no preprocessor {name!r}")


class EnvHandle:
    """Gym-style stateful adapter over a functional env, holding a batch of
    one state on ``device``. Forking (the reference's ``safe_deepcopy_env``)
    stamps the state into a new handle; state tensors are never written in
    place, so sharing them is safe."""

    def __init__(self, env: FunctionalEnv, params=None, config: Dict | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.functional = env
        self.params = params_to(params if params is not None
                                else env.default_params(self.device), self.device)
        self.config = dict(config or {})
        self.state = None
        self.obs = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        # the reference's load_environment resets envs on creation
        # (factory.py:59-94); planners rely on a live state
        self.reset(seed=self.config.get("seed"))

    @property
    def spec(self):
        return self.functional.spec

    @property
    def unwrapped(self):
        return self

    @property
    def action_space(self):
        return self.functional.action_space

    @property
    def observation_space(self):
        return self.functional.observation_space

    def get_available_actions(self):
        """Discrete action ids at the current state (the reference's planners
        call this on env copies, e.g. mcts_dpw.py:119-126)."""
        space = self.functional.action_space
        if hasattr(space, "spaces"):  # multi-agent: one agent's discrete set
            space = space.spaces[0]
        return list(range(space.n))

    def seed(self, seed: int | None = None):
        if seed is not None:
            self.generator.manual_seed(seed)
        return [seed]

    def reset(self, seed: int | None = None, **kwargs):
        if seed is not None:
            self.seed(seed)
        self.state, self.obs = self.functional.reset(self.params, self.generator, 1)
        return _first(self.obs), {}

    def step(self, action):
        space = self.functional.action_space
        if isinstance(space, Discrete) and np.ndim(action) != 0:
            # a continuous controller's control vector is no discrete action
            # (JAX's envs fail on its shape)
            raise ValueError(f"a discrete action is a scalar, got shape {np.shape(action)}")
        dtype = torch.float32 if isinstance(space, Box) else torch.int64
        action = torch.as_tensor(np.asarray(action), dtype=dtype, device=self.device)
        action = action.reshape((1,) + tuple(space.shape))
        out = self.functional.step(self.params, self.state, action, self.generator)
        self.state, self.obs = out.state, out.obs
        info = {k: v[0].cpu().numpy() for k, v in out.info.items()
                if isinstance(v, torch.Tensor) and v.dim() > 0}
        return (_first(out.obs), float(out.reward[0]), bool(out.terminated[0]),
                bool(out.truncated[0]), info)

    def to_finite_mdp(self):
        """Finite-MDP view around the current state, for envs whose functional
        core supports the conversion (value_iteration.py:29-35)."""
        fn = getattr(self.functional, "to_finite_mdp", None)
        if fn is None:
            raise TypeError(f"{type(self.functional).__name__} has no finite-MDP view")
        return fn(self.params, self.state)

    def render(self):
        """Nothing, as in the JAX package: frames come from
        ``graphics/render.py`` and ``graphics/pygame_viewer.py``."""
        return None

    def close(self):
        pass

    def fork(self) -> "EnvHandle":
        new = EnvHandle.__new__(EnvHandle)
        new.__dict__.update(self.__dict__)
        new.generator = torch.Generator(device=self.device)
        new.generator.set_state(self.generator.get_state())
        return new

    def preprocess(self, name, args):
        """A fork of this handle through the functional env's preprocessor
        ``name``. The preprocessor returns a new functional env, or a pair
        ``(functional, transform)`` whose ``transform(params, state)`` maps this
        handle's params and state into the new env's, which then re-observes
        the state. A preprocessor the env does not know (ValueError) leaves
        the fork as it is."""
        new = self.fork()
        try:
            result = self.functional.preprocess(name, args)
        except ValueError:
            return new
        if isinstance(result, tuple):
            new.functional, transform = result
            if self.state is not None:
                new.params, new.state = transform(self.params, self.state)
            if new.state is not None:
                new.obs = new.functional.observe(new.params, new.state)
        else:
            new.functional = result
        return new


def _first(obs):
    """The first row of a batch observation (a tensor, a tuple of them with
    several controlled agents, or a dict of them) as numpy."""
    if isinstance(obs, tuple):
        return tuple(o[0].cpu().numpy() for o in obs)
    if isinstance(obs, dict):
        return {k: v[0].cpu().numpy() for k, v in obs.items()}
    return obs[0].cpu().numpy()


def vector_step(env: FunctionalEnv) -> Callable:
    """The batched step ``(params, states, actions, generator, noise) ->
    StepOut`` over a leading batch axis: the env's own ``step``, which is
    batch-first (the JAX package vmaps its single-state step here)."""
    return env.step


def vector_reset(env: FunctionalEnv) -> Callable:
    """The batched reset ``(params, generator, batch) -> (states, obs)``."""
    return env.reset


def policy_rollout(env: FunctionalEnv, policy: Callable, params, state, horizon: int,
                   generator: torch.Generator | None = None, policy_noise=None,
                   env_noise=None) -> StepOut:
    """Roll ``policy(obs, draw) -> actions [B]`` from ``state`` for ``horizon``
    batch steps. ``draw`` is ``policy_noise[t]`` (None when not given) and the
    env steps with ``env_noise[t]`` or draws from ``generator``: the JAX
    package splits its key into a policy key and a step key at every step.

    Returns the stacked ``StepOut``s; a row's rewards after its episode ends
    are zeroed (a ``live`` flag is carried, as in the JAX package)."""
    obs = env.observe(params, state)
    live = torch.ones(state[0].shape[0], dtype=torch.bool, device=state[0].device)
    outs = []
    for t in range(horizon):
        action = policy(obs, None if policy_noise is None else policy_noise[t])
        out = env.step(params, state, action, generator,
                       None if env_noise is None else env_noise[t])
        outs.append(out._replace(reward=torch.where(live, out.reward, 0.0)))
        live = live & ~out.done
        state, obs = out.state, out.obs
    return stack(outs)
