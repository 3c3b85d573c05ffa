"""Fitted-Q iteration agent.

Port of ``rl_agents_tpu/agents/fitted_q.py`` (reference:
fitted_q/abstract.py:13-114, fitted_q/pytorch.py) on the port's
``DQNAgent``: a batched agent (``batched = True`` routes
``Evaluation.train`` into batched episodes) whose ``record`` only stores
transitions; ``update()`` runs N value-iteration epochs (N = 3 / (1 - gamma)
when not set), each a hard target sync, a fresh model and M regression
steps on minibatches of 64 with gradients clipped to [-1, 1]. The
regression loss is the squared error, whatever the config's
``loss_function``, as in the JAX package.
"""
from __future__ import annotations

import logging
from pathlib import Path

import torch

from rl_agents_torch.agents.dqn.agent import DQNAgent, TrainState, make_train_step
from rl_agents_torch.agents.dqn.replay import Batch
from rl_agents_torch.models.optimizers import loss_function_factory

logger = logging.getLogger(__name__)

MINIBATCH = 64  # fixed in the JAX package (fitted_q.py:88)


def make_ftq_epoch(model, optimizer, gamma: float, double: bool, regression_epochs: int,
                   batch_size: int):
    """One fitted-Q value-iteration epoch: ``epoch(params, target_params,
    opt_state, data, size, generator, indices=None) -> (params, opt_state,
    losses [regression_epochs])``. Step i takes the minibatch at
    ``indices[i]`` (``[regression_epochs, batch_size]``), or at indices drawn
    uniformly below ``size`` from ``generator``."""
    train_step, _ = make_train_step(model, optimizer, loss_function_factory("l2"), gamma, double)

    def epoch(params, target_params, opt_state, data: Batch, size: int,
              generator: torch.Generator | None, indices=None):
        device = data.reward.device
        if indices is None:
            indices = torch.randint(0, int(size), (regression_epochs, batch_size),
                                    generator=generator, device=device)
        else:
            indices = torch.as_tensor(indices, dtype=torch.int64).to(device)
        state = TrainState(params, target_params, opt_state)
        losses = []
        for step in range(regression_epochs):
            state, loss = train_step(state, Batch(*(x[indices[step]] for x in data)))
            losses.append(loss)
        return state.params, state.opt_state, torch.stack(losses)

    return epoch


class FTQAgent(DQNAgent):
    """(reference: fitted_q/abstract.py + fitted_q/pytorch.py)"""

    batched = True

    @classmethod
    def default_config(cls):
        cfg = super().default_config()
        cfg.update({
            "value_iteration_epochs": None,  # None -> 3/(1-gamma), "from-gamma" accepted
            "regression_epochs": 50,
            "processes": 1,
            "constraint_penalty": 0,
        })
        return cfg

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(env, config, device=device)
        self._epoch = make_ftq_epoch(self.model, self.optimizer, self.config["gamma"],
                                     self.config["double"], self.config["regression_epochs"],
                                     MINIBATCH)
        self.iterations_time = 0

    @property
    def value_iteration_epochs(self) -> int:
        epochs = self.config["value_iteration_epochs"]
        if not epochs or epochs == "from-gamma":
            epochs = int(3 / (1 - self.config["gamma"]))
        return int(epochs)

    def record(self, state, action, reward, next_state, done, info):
        """Store only (reference: fitted_q/abstract.py:30-46), with the
        constraint penalty folded into the reward when configured."""
        if not self.training:
            return
        if self.config["constraint_penalty"] and info and "constraint" in info:
            reward = reward + self.config["constraint_penalty"] * info["constraint"]
        self.memory.push(state, action, reward, next_state, done, info)

    def update(self, indices=None, init_params=None):
        """N value-iteration epochs x M regression steps (reference:
        fitted_q/abstract.py:48-81). ``indices`` (one ``[M, 64]`` array per
        epoch) and ``init_params`` (one parameter dict per model
        re-initialization, N + 1 of them) replace the agent's own draws."""
        init_params = iter(init_params) if init_params is not None else None
        self._initialize(init_params)
        data, size = self.memory.data, self.memory.size
        for epoch_i in range(self.value_iteration_epochs):
            # hard target sync, then fit a fresh model
            self.train_state = self.train_state._replace(target_params=self.train_state.params)
            self._initialize(init_params)
            params, opt_state, losses = self._epoch(
                self.train_state.params, self.train_state.target_params,
                self.train_state.opt_state, data, size, self.generator,
                None if indices is None else indices[epoch_i])
            self.train_state = TrainState(params, self.train_state.target_params, opt_state)
            if self.writer:
                self.writer.add_scalar("agent/bellman_residual", float(losses[0]),
                                       self.iterations_time)
                self.writer.add_scalar("agent/regression_loss", float(losses[-1]),
                                       self.iterations_time)
                self.iterations_time += 1
            logger.debug("FTQ epoch %d/%d done", epoch_i + 1, self.value_iteration_epochs)

    def _initialize(self, init_params):
        if init_params is None:
            self.initialize_model()
            return
        params = {k: torch.as_tensor(v).to(self.device) for k, v in next(init_params).items()}
        self.train_state = TrainState(params, self.train_state.target_params,
                                      self.optimizer.init(list(params.values())))

    def save(self, filename):
        path = super().save(filename)
        torch.save(self.memory.state_dict(), Path(filename).with_suffix(".data"))
        logger.info("Saved a replay memory of length %d", len(self.memory))
        return path

    def load(self, filename):
        path = super().load(filename)
        data_file = Path(filename).with_suffix(".data")
        if data_file.exists():
            self.memory.load_state_dict(torch.load(data_file, map_location=self.device,
                                                   weights_only=True))
            logger.info("Loaded a replay memory of length %d", len(self.memory))
        return path
