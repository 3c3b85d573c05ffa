"""Deep Q-Network agent.

Port of ``rl_agents_tpu/agents/dqn/agent.py`` (reference:
deep_q_network/abstract.py:10-170 and pytorch.py:14-104): ``record`` pushes
to replay, samples a minibatch, takes a Bellman-residual SGD step with
elementwise gradient clipping to [-1, 1] (pytorch.py:32-38), and syncs the
target network every ``target_update`` steps; ``act`` runs the exploration
policy over Q(s). Double-DQN target by default (pytorch.py:56-69).

The update is functional, as the JAX package's: ``TrainState`` holds the
parameters, the target parameters and the optimizer state as tensors on the
agent's device, and the model is evaluated on them with
``torch.func.functional_call``. The action value Q(s, a) is a ``gather``
(the JAX package's one-hot sum, exact for finite Q). Checkpoints are
``torch.save`` files of the three.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from rl_agents_torch.agents.base import AbstractStochasticAgent
from rl_agents_torch.agents.dqn.exploration import exploration_factory
from rl_agents_torch.agents.dqn.replay import Batch, ReplayMemory
from rl_agents_torch.models.optimizers import (
    apply_updates,
    loss_function_factory,
    optimizer_factory,
)
from rl_agents_torch.models.zoo import (
    init_parameters,
    model_factory,
    size_model_config,
    trainable_parameters,
)
from rl_agents_torch.utils.device import resolve_device


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: dict


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of ``model``'s parameters, by name."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def q_values(model, params, x):
    return functional_call(model, params, (x,))


def select_action_values(q, actions):
    """Q(s, a) for a ``[B]`` action vector."""
    return q.gather(1, actions[:, None]).squeeze(1)


def bellman_targets(model, params, target_params, batch: Batch, gamma: float, double: bool):
    """r + gamma * (1 - terminal) * Q_target(s', a*), with a* the online
    argmax when ``double``, else the target's max."""
    with torch.no_grad():
        q_next = q_values(model, target_params, batch.next_state)
        if double:
            best_actions = q_values(model, params, batch.next_state).argmax(dim=1)
            best_values = select_action_values(q_next, best_actions)
        else:
            best_values = q_next.max(dim=1).values
        next_values = torch.where(batch.terminal, 0.0, best_values)
        return batch.reward + gamma * next_values


def loss_and_gradients(model, loss_fn, params, target_params, batch: Batch, gamma: float,
                       double: bool):
    """(Bellman-residual loss, its gradients in ``params`` order) at
    ``params``, the target held fixed."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    target = bellman_targets(model, leaves, target_params, batch, gamma, double)
    q_sa = select_action_values(q_values(model, leaves, batch.state), batch.action)
    loss = loss_fn(q_sa, target)
    return loss.detach(), list(torch.autograd.grad(loss, list(leaves.values())))


def clip_gradients_(grads):
    """Clip every gradient elementwise to [-1, 1] in place (pytorch.py:32-38)."""
    torch._foreach_clamp_min_(grads, -1.0)
    torch._foreach_clamp_max_(grads, 1.0)
    return grads


def make_train_step(model, optimizer, loss_fn, gamma: float, double: bool):
    """The DQN update: loss -> grads -> clip [-1, 1] -> optimizer. Returns
    ``(train_step, compute_loss)``: ``train_step(state, batch) -> (state,
    loss)`` and ``compute_loss(params, target_params, batch)``."""

    def train_step(state: TrainState, batch: Batch):
        loss, grads = loss_and_gradients(model, loss_fn, state.params, state.target_params,
                                         batch, gamma, double)
        clip_gradients_(grads)
        names, values = list(state.params), list(state.params.values())
        updates, opt_state = optimizer.update(grads, state.opt_state, values)
        params = dict(zip(names, apply_updates(values, updates)))
        return TrainState(params, state.target_params, opt_state), loss

    def compute_loss(params, target_params, batch: Batch):
        with torch.no_grad():
            target = bellman_targets(model, params, target_params, batch, gamma, double)
            q_sa = select_action_values(q_values(model, params, batch.state), batch.action)
            return loss_fn(q_sa, target)

    return train_step, compute_loss


class DQNAgent(AbstractStochasticAgent):
    batched = False

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self.env = env
        action_space = env.action_space
        obs_space = env.observation_space
        if hasattr(action_space, "spaces"):  # multi-agent: per-ego spaces
            action_space = action_space.spaces[0]
            obs_space = obs_space.spaces[0]
        assert hasattr(action_space, "n"), "Only compatible with Discrete action spaces."
        size_model_config(self.env, self.config["model"])
        self.obs_shape = tuple(obs_space.shape or (1,))
        self.model = model_factory(self.config["model"], self.obs_shape).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        params = model_params(init_parameters(self.model, self.generator))
        self.optimizer = optimizer_factory(
            self.config["optimizer"]["type"], lr=self.config["optimizer"].get("lr", 5e-4),
            weight_decay=self.config["optimizer"].get("weight_decay", 0.0))
        self.train_state = TrainState(params, {k: v.clone() for k, v in params.items()},
                                      self.optimizer.init(list(params.values())))
        self.loss_function = loss_function_factory(self.config["loss_function"])
        self.train_step, self.compute_loss = make_train_step(
            self.model, self.optimizer, self.loss_function,
            self.config["gamma"], self.config["double"])

        self.memory = ReplayMemory(self.config["memory_capacity"], self.obs_shape,
                                   n_steps=self.config.get("n_steps", 1),
                                   gamma=self.config["gamma"], device=self.device,
                                   generator=self.generator)
        self.exploration_policy = exploration_factory(self.config["exploration"],
                                                      self.env.action_space)
        self.training = True
        self.previous_state = None
        self.steps = 0

    @classmethod
    def default_config(cls):
        return dict(model=dict(type="DuelingNetwork"),
                    optimizer=dict(type="ADAM", lr=5e-4, weight_decay=0, k=5),
                    loss_function="l2",
                    memory_capacity=50000,
                    batch_size=100,
                    gamma=0.99,
                    exploration=dict(method="EpsilonGreedy"),
                    target_update=1,
                    double=True)

    # ------------------------------------------------------------------
    # Interaction (reference: abstract.py:37-83)
    # ------------------------------------------------------------------
    def record(self, state, action, reward, next_state, done, info, indices=None):
        """Push the transition (one row per ego for a tuple state), then take
        one SGD step on a minibatch at ``indices``, or at indices drawn from
        the agent's generator."""
        if not self.training:
            return
        if isinstance(state, tuple) and isinstance(action, tuple):  # multi-agent
            for s, a, ns in zip(state, action, next_state):
                self.memory.push(s, a, reward, ns, done, info)
        else:
            self.memory.push(state, action, reward, next_state, done, info)
        batch = self.sample_minibatch(indices)
        if batch is not None:
            self.train_state, loss = self.train_step(self.train_state, batch)
            if self.writer and self.steps % 100 == 0:
                self.writer.add_scalar("agent/loss", float(loss), self.steps)
            self.update_target_network()

    def act(self, state, step_exploration_time=True):
        self.previous_state = state
        if step_exploration_time:
            self.exploration_policy.step_time()
        if isinstance(state, tuple):
            return tuple(self.act(s, step_exploration_time=False) for s in state)
        values = self.get_state_action_values(state)
        self.exploration_policy.update(values)
        return self.exploration_policy.sample()

    def sample_minibatch(self, indices=None):
        if len(self.memory) < self.config["batch_size"]:
            return None
        return self.memory.sample(self.config["batch_size"], indices)

    def update_target_network(self):
        self.steps += 1
        if self.steps % self.config["target_update"] == 0:
            self.train_state = self.train_state._replace(
                target_params={k: v.clone() for k, v in self.train_state.params.items()})

    # ------------------------------------------------------------------
    # Value queries (reference: abstract.py:108-140)
    # ------------------------------------------------------------------
    def get_batch_state_values(self, states):
        q = self.get_batch_state_action_values(states)
        return np.max(q, axis=1), np.argmax(q, axis=1)

    def get_batch_state_action_values(self, states):
        states = torch.tensor(np.asarray(states), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            q = q_values(self.model, self.train_state.params, states)
        return q.float().cpu().numpy()

    def get_state_value(self, state):
        values, actions = self.get_batch_state_values(np.asarray(state)[None])
        return values[0], actions[0]

    def get_state_action_values(self, state):
        return self.get_batch_state_action_values(np.asarray(state)[None])[0]

    def action_distribution(self, state):
        self.previous_state = state
        values = self.get_state_action_values(state)
        self.exploration_policy.update(values)
        return self.exploration_policy.get_distribution()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def seed(self, seed=None):
        if seed is not None:
            self.generator.manual_seed(seed)
        return self.exploration_policy.seed(seed)

    def reset(self):
        pass

    def set_time(self, time):
        self.exploration_policy.set_time(time)

    def set_writer(self, writer):
        super().set_writer(writer)
        self.exploration_policy.set_writer(writer)
        if writer is not None:
            writer.add_scalar("agent/trainable_parameters", trainable_parameters(self.model), 0)

    def explore(self, enable: bool):
        """Force pure exploration (reference: evaluation.py:266-267 sets
        final_temperature=1 in the worker config)."""
        if enable:
            self._saved_exploration = dict(self.config["exploration"])
            self.config["exploration"]["final_temperature"] = 1
        elif getattr(self, "_saved_exploration", None) is not None:
            self.config["exploration"] = self._saved_exploration
            self._saved_exploration = None
        self.exploration_policy = exploration_factory(self.config["exploration"],
                                                      self.env.action_space)

    def eval(self):
        self.training = False
        self.config["exploration"]["method"] = "Greedy"
        self.exploration_policy = exploration_factory(self.config["exploration"],
                                                      self.env.action_space)

    def train(self):
        self.training = True

    # ------------------------------------------------------------------
    # Fused whole-run training (config key "fused": true)
    # ------------------------------------------------------------------
    def train_fused(self, env_handle, num_episodes, writer=None):
        """Run the whole training as one fused on-device actor-learner
        (``parallel/actor_learner.py``): ``fused_envs`` envs act, write a
        device replay ring and take one SGD step per env-batch step, for
        ``num_episodes * max_episode_steps`` env transitions in all. The
        learned parameters, target and optimizer state are synced back into
        the agent, so that act/eval/save behave as after ``record``."""
        from rl_agents_torch.parallel.actor_learner import make_actor_learner

        functional = env_handle.functional
        expl = dict(self.exploration_policy.config)
        num_envs = int(self.config.get("fused_envs", 32))
        max_steps = int(getattr(functional, "max_episode_steps", 200) or 200)
        total = max(num_episodes * max_steps // num_envs, 1)
        segment = min(max(total // 10, 1), 1000)

        init_fn, segment_fn = make_actor_learner(
            functional, self.model, self.optimizer,
            num_envs=num_envs,
            capacity=int(self.config["memory_capacity"]),
            batch_size=int(self.config["batch_size"]),
            gamma=float(self.config["gamma"]),
            double=bool(self.config["double"]),
            target_update=int(self.config["target_update"]),
            eps_init=float(expl.get("temperature", 1.0)),
            eps_final=float(expl.get("final_temperature", 0.1)),
            eps_tau=float(expl.get("tau", 5000)),
            n_steps=int(self.config.get("n_steps", 1)),
            updates_per_step=int(self.config.get("updates_per_step", 1)),
            sample_mode=str(self.config.get("sample_mode", "uniform")),
            device=self.device)
        state = init_fn(self.generator, env_params=env_handle.params)
        done_steps = 0
        while done_steps < total:
            steps = min(segment, total - done_steps)
            state, mean_reward = segment_fn(state, steps=steps)
            done_steps += steps
            if writer is not None:
                writer.add_scalar("episode/ema_return", float(state.completed_return),
                                  done_steps * num_envs)
                writer.add_scalar("agent/mean_reward", float(mean_reward),
                                  done_steps * num_envs)
        self.train_state = TrainState(params=state.params, target_params=state.target_params,
                                      opt_state=state.opt_state)
        self.exploration_policy.set_time(int(state.time))
        self.steps = int(state.time)
        return float(state.completed_return)

    def save(self, filename):
        """Save parameters, target and optimizer state with ``torch.save``;
        with ``"checkpoint_format": "orbax"``, as a ``save_pytree``
        directory at ``filename.with_suffix(".orbax")``, whose path is
        returned (JAX's ``agent.py:291-320``)."""
        filename = Path(filename)
        filename.parent.mkdir(parents=True, exist_ok=True)
        if self.config.get("checkpoint_format") == "orbax":
            from rl_agents_torch.trainer.checkpoint import save_pytree

            return save_pytree(filename.with_suffix(".orbax"), self.train_state._asdict())
        torch.save(_to_cpu(self.train_state._asdict()), filename)
        return filename

    def load(self, filename):
        filename = Path(filename)
        if self.config.get("checkpoint_format") == "orbax" or filename.suffix == ".orbax":
            from rl_agents_torch.trainer.checkpoint import load_pytree

            restored = load_pytree(filename.with_suffix(".orbax"),
                                   template=self.train_state._asdict())
            self.train_state = TrainState(**restored)
            return filename
        state = torch.load(filename, map_location=self.device, weights_only=True)
        self.train_state = TrainState(**state)
        return filename

    def initialize_model(self):
        params = model_params(init_parameters(self.model, self.generator))
        self.train_state = TrainState(params, self.train_state.target_params,
                                      self.optimizer.init(list(params.values())))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return copy.deepcopy(tree)
