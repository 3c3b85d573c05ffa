"""TrailBlazer: sample-efficient Monte-Carlo planning (MaxNode/AvgNode recursion).

Port of ``rl_agents_tpu/agents/tree_search/trailblazer.py`` (reference:
tree_search/trailblazer.py:6-142). The adaptive recursion, whose candidate
elimination and per-node sample counts depend on sampled values, stays on
the host as coroutines that yield oracle requests ``(state, action, n)`` and
receive their samples, so the sampling pattern does not depend on who runs
the requests:

* ``TrailBlazer`` drains one instance's requests, one env step per request;
* ``BatchedTrailBlazer`` runs B instances' coroutines in lockstep rounds and
  runs all requests of a round as one padded env step on the device, so the
  number of dispatches per plan is the longest sequential request chain of
  the batch, not the sum over instances.

Node states live on the host as numpy rows; a round stacks them once, steps
``[requests x samples]`` states (both padded to powers of two) and reads the
child states, rewards and observations back once. ``dispatches`` counts the
rounds.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.utils.device import resolve_device


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def host_state(state):
    """The first row of a batch state NamedTuple, as numpy arrays."""
    return type(state)(*(x[0].cpu().numpy() for x in state))


class MaxNode:
    def __init__(self, planner, state, depth=0, obs_key=None):
        self.planner = planner
        self.state = state
        self.depth = depth
        self.obs_key = obs_key
        self.children = [AvgNode(planner, state, action, depth + 1)
                         for action in range(planner.K)]

    def run_gen(self, m, epsilon):
        """(reference: trailblazer.py:20-39), as a coroutine: every oracle
        draw below this node surfaces through ``yield``."""
        p = self.planner
        candidates = list(self.children)
        L = 1
        U = 1 / (1 - p.gamma)
        mu = []
        # the oracle budget (an anytime cap the reference lacks) also stops
        # the refinement loop: without draws left every round re-walks the
        # same cached estimates
        while len(candidates) > 1 and U >= (1 - p.eta) * epsilon \
                and p.oracle_calls < p.max_oracle_calls:
            sqr = (np.log(p.K * L / (p.delta * epsilon))
                   + p.gamma / (p.eta - p.gamma) + p.alpha + 1) / L
            U = 2 / (1 - p.gamma) * np.sqrt(max(sqr, 0.0))
            mu = []
            for b in candidates:
                value = yield from b.run_gen(L, U * p.eta / (1 - p.eta))
                mu.append((b, value))
            mu_sup = max(mu, key=lambda c: c[1])[1]
            candidates = [c[0] for c in mu
                          if c[1] + 2 * U / (1 - p.eta) >= mu_sup - 2 * U / (1 - p.eta)]
            L += 1
        if len(candidates) > 1 and mu:
            return max(mu, key=lambda c: c[1])[1]
        # mu is empty when the budget ran out before the first round here:
        # evaluate the leading candidate from its cached samples
        value = yield from candidates[0].run_gen(m, p.eta * epsilon)
        return value


class AvgNode:
    def __init__(self, planner, state, action, depth):
        self.planner = planner
        self.state = state
        self.action = action
        self.depth = depth
        self.sampled_nodes = []
        self.r = 0.0

    def run_gen(self, m, epsilon):
        """(reference: trailblazer.py:62-92)"""
        p = self.planner
        m = int(np.ceil(m))
        if epsilon >= 1 / (1 - p.gamma):
            return 0.0
        if p.oracle_calls >= p.max_oracle_calls:
            # budget cap: the current empirical estimate
            return self.r / max(len(self.sampled_nodes), 1)
        need = min(m - len(self.sampled_nodes), p.max_oracle_calls - p.oracle_calls)
        if need > 0:
            p.oracle_calls += need
            states, reward_sum, keys = yield (self.state, self.action, need)
            for i in range(need):
                child_state = type(states)(*(x[i] for x in states))
                self.sampled_nodes.append(MaxNode(p, child_state, self.depth + 1,
                                                  obs_key=keys[i]))
            self.r += reward_sum
        if not self.sampled_nodes:
            return self.r
        active_nodes = self.sampled_nodes[:m]
        # aggregate duplicates by observation (reference: trailblazer.py:42-44)
        uniques, counts = [], []
        index = {}
        for s in active_nodes:
            i = index.get(s.obs_key)
            if i is None:
                index[s.obs_key] = len(uniques)
                uniques.append(s)
                counts.append(1)
            else:
                counts[i] += 1
        mu = 0.0
        for node, count in zip(uniques, counts):
            nu = yield from node.run_gen(count, epsilon / p.gamma)
            mu += count / m * nu
        return self.r / max(len(self.sampled_nodes), 1) + p.gamma * mu


class OracleExecutor:
    """Runs a round of oracle requests, from any number of instances, as one
    padded env step, and counts the rounds in ``dispatches``."""

    def __init__(self, functional, params, generator: torch.Generator, device):
        self.functional = functional
        self.params = params
        self.generator = generator
        self.device = device
        self.dispatches = 0

    def __call__(self, requests):
        """``requests``: ``(state, action, need)`` each. Returns ``(child
        states [need, ...] as numpy, reward sum, observation keys)`` each."""
        if not requests:
            return []
        self.dispatches += 1
        r, n = len(requests), max(q[2] for q in requests)
        r_pad, n_pad = _pow2(r), _pow2(n)
        all_reqs = list(requests) + [requests[0]] * (r_pad - r)
        first = all_reqs[0][0]
        # host-side assembly and one transfer each way for the whole round
        states = type(first)(*(torch.as_tensor(np.repeat(np.stack([q[0][f] for q in all_reqs]),
                                                         n_pad, axis=0)).to(self.device)
                               for f in range(len(first))))
        actions = torch.as_tensor(np.repeat(np.array([int(q[1]) for q in all_reqs]), n_pad),
                                  device=self.device)
        out = self.functional.step(self.params, states, actions, self.generator)
        c_states = type(first)(*(x.reshape((r_pad, n_pad) + x.shape[1:]).cpu().numpy()
                                 for x in out.state))
        rewards = out.reward.to(torch.float32).reshape(r_pad, n_pad).cpu().numpy()
        obs = out.obs[0] if isinstance(out.obs, tuple) else out.obs
        obs = obs.reshape((r_pad, n_pad) + obs.shape[1:]).cpu().numpy()
        results = []
        for i, (_, _, need) in enumerate(requests):
            child_states = type(first)(*(x[i] for x in c_states))
            keys = [obs[i, j].tobytes() for j in range(need)]
            results.append((child_states, float(rewards[i, :need].sum()), keys))
        return results


def drive(generators, executor):
    """Run coroutines in lockstep rounds: gather every pending request, run
    them in one dispatch, resume. Returns the coroutines' return values."""
    values = [None] * len(generators)
    pending = {}
    for i, g in enumerate(generators):
        try:
            pending[i] = g.send(None)
        except StopIteration as stop:
            values[i] = stop.value
    while pending:
        idxs = sorted(pending)
        results = executor([pending[i] for i in idxs])
        pending = {}
        for i, res in zip(idxs, results):
            try:
                pending[i] = generators[i].send(res)
            except StopIteration as stop:
                values[i] = stop.value
    return values


class TrailBlazer:
    """(reference: trailblazer.py:95-117), on the state of ``env_handle``."""

    def __init__(self, env_handle, gamma=0.9, delta=0.1, epsilon=1.0,
                 max_oracle_calls: int = 10000, seed: int = 0, state=None):
        self.max_oracle_calls = max_oracle_calls
        self.functional = env_handle.functional
        self.params = env_handle.params
        self.gamma = gamma
        self.delta = delta
        self.epsilon = epsilon
        self.eta = np.power(gamma, 1 / max(2, np.log(1 / epsilon)))
        self.K = self.functional.action_space.n
        self.alpha = 0.0
        self.m = (np.log(1 / delta) + self.alpha) / ((1 - gamma) ** 2 * epsilon ** 2)
        self.oracle_calls = 0
        device = resolve_device(env_handle.device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        self.executor = OracleExecutor(self.functional, self.params, generator, device)
        self.root = MaxNode(self, host_state(env_handle.state) if state is None else state)

    @property
    def dispatches(self):
        return self.executor.dispatches

    def run(self):
        return drive([self.root.run_gen(self.m, self.epsilon / 2)], self.executor)[0]


class BatchedTrailBlazer:
    """B independent TrailBlazer instances whose oracle draws run as one
    dispatch per lockstep round. ``states`` are batch-of-one state
    NamedTuples (an ``EnvHandle.state``)."""

    def __init__(self, env_handle, states, gamma=0.9, delta=0.1, epsilon=1.0,
                 max_oracle_calls: int = 10000, seed: int = 0):
        self.instances = [TrailBlazer(env_handle, gamma=gamma, delta=delta, epsilon=epsilon,
                                      max_oracle_calls=max_oracle_calls, seed=seed,
                                      state=host_state(state))
                          for state in states]
        self.executor = self.instances[0].executor
        for tb in self.instances:
            tb.executor = self.executor  # shared: one dispatch per round

    @property
    def dispatches(self):
        return self.executor.dispatches

    def run(self):
        gens = [tb.root.run_gen(tb.m, tb.epsilon / 2) for tb in self.instances]
        return drive(gens, self.executor)
