"""Budgeted Fitted-Q core.

Port of ``rl_agents_tpu/agents/budgeted_ftq/bftq.py`` (reference:
budgeted_ftq/bftq.py:25-335): fit a (Qr, Qc) model of state-budget-action
values by repeated application of the Budgeted Bellman Optimality operator.
Each epoch:

1. one forward of every next state at every budget of the discretised grid
   (bftq.py:190-214);
2. each state's Pareto frontier of (Qc, Qr) and its budget-constrained
   optimal mixture (``greedy_policy.py``, all states at once);
3. the targets ``r + gamma * Vr`` and ``c + gamma_c * Vc`` (bftq.py:129-148);
   the first epoch bootstraps zeros (bftq.py:164-165), so its targets are
   the rewards and costs and it makes no forward;
4. ``regression_epochs`` full-batch gradient steps with gradients clipped to
   [-1, 1], the network reset first when ``reset_network_each_epoch``
   (bftq.py:252-305).

The network is evaluated with ``torch.func.functional_call`` on a parameter
dict; a reset draws new parameters from the ``torch.Generator`` it is given,
on the network's device. ``push`` keeps the beta-duplication augmentation
(bftq.py:53-74).
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from rl_agents_torch.agents.budgeted_ftq.greedy_policy import (
    HULL_BUDGET,
    Mixture,
    batch_mixtures,
)
from rl_agents_torch.agents.dqn.agent import clip_gradients_, model_params
from rl_agents_torch.models.optimizers import (
    apply_updates,
    loss_function_factory,
    optimizer_factory,
)
from rl_agents_torch.models.zoo import init_parameters
from rl_agents_torch.utils.math import fma


def parse_betas(value) -> np.ndarray:
    """A betas spec as float32: a list, or the reference's
    ``"np.arange(0, 1, 0.1)"`` / ``"np.linspace(a, b, n)"`` strings, parsed
    without ``eval`` (budgeted_ftq/bftq.py:331-335)."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return np.asarray(value, dtype=np.float32)
    if isinstance(value, str):
        m = re.fullmatch(r"\s*np\.arange\(([^)]*)\)\s*", value)
        if m:
            args = [float(a) for a in m.group(1).split(",")]
            return np.arange(*args).astype(np.float32)
        m = re.fullmatch(r"\s*np\.linspace\(([^)]*)\)\s*", value)
        if m:
            args = [float(a) for a in m.group(1).split(",")]
            count = int(args[2]) if len(args) > 2 else 50
            return np.linspace(args[0], args[1], count).astype(np.float32)
    raise ValueError(f"Unsupported betas spec: {value!r}")


class BFTQBatch(NamedTuple):
    state: torch.Tensor       # [N, D]
    action: torch.Tensor      # [N] i64
    reward: torch.Tensor      # [N]
    next_state: torch.Tensor  # [N, D]
    terminal: torch.Tensor    # [N] bool
    cost: torch.Tensor        # [N]
    beta: torch.Tensor        # [N]


def next_mixtures(network, params, batch: BFTQBatch, betas_disc,
                  hull_budget: int = HULL_BUDGET) -> Mixture:
    """The optimal mixture at each next state under its budget: the network
    at every discretised budget, then each state's frontier."""
    S, B = batch.next_state.shape[0], betas_disc.shape[0]
    states = batch.next_state.repeat_interleave(B, dim=0)
    budgets = betas_disc.repeat(S)[:, None]
    with torch.no_grad():
        q = functional_call(network, params, (torch.cat([states, budgets], dim=1),))
    return batch_mixtures(q.reshape(S, B, -1), betas_disc, batch.beta, hull_budget)


def compute_targets(network, params, batch: BFTQBatch, betas_disc, bootstrap: bool,
                    gamma: float, gamma_c: float, clamp_qc=None, hull_budget: int = HULL_BUDGET):
    """Budgeted Bellman Optimality targets ``(target_r, target_c)``, each
    ``[N]`` (bftq.py:129-188). Without ``bootstrap`` the next values are 0."""
    mixture = next_mixtures(network, params, batch, betas_disc, hull_budget) if bootstrap else None
    return mixture_targets(mixture, batch, gamma, gamma_c, clamp_qc)


def mixture_targets(mixture: Mixture | None, batch: BFTQBatch, gamma: float, gamma_c: float,
                    clamp_qc=None):
    """The targets of ``compute_targets`` from the next states' mixtures
    (None: next values 0)."""
    f32 = torch.float32
    if mixture is not None:
        p = mixture.probability_sup
        # (1 - p) * inf + p * sup: XLA fuses the second product and the sum
        next_r = fma(p, mixture.qr_sup, (1 - p) * mixture.qr_inf)
        next_c = fma(p, mixture.qc_sup, (1 - p) * mixture.qc_inf)
        live = ~batch.terminal
        next_r = torch.where(live, next_r, 0.0)
        next_c = torch.where(live, next_c, 0.0)
    else:
        next_r = next_c = torch.zeros_like(batch.reward)
    target_r = fma(torch.full((), gamma, dtype=f32, device=next_r.device), next_r, batch.reward)
    target_c = fma(torch.full((), gamma_c, dtype=f32, device=next_c.device), next_c, batch.cost)
    if clamp_qc is not None:
        target_c = torch.clamp(target_c, clamp_qc[0], clamp_qc[1])
    return target_r, target_c


def make_loss(network, n_actions: int, loss_r, loss_c, weights):
    """``loss(params, sb, actions, target_r, target_c)``: the weighted losses
    of Qr(s, beta, a) and Qc(s, beta, a) against their targets."""
    w_r, w_c = weights

    def loss(params, sb, actions, target_r, target_c):
        values = functional_call(network, params, (sb,))
        qr = values[:, :n_actions].gather(1, actions[:, None])[:, 0]
        qc = values[:, n_actions:].gather(1, actions[:, None])[:, 0]
        return w_r * loss_r(qr, target_r) + w_c * loss_c(qc, target_c)

    return loss


def make_fit(loss, optimizer, regression_epochs: int):
    """``fit(params, opt_state, sb, actions, target_r, target_c) -> (params,
    opt_state, losses [regression_epochs])``: full-batch gradient steps, the
    gradients clipped to [-1, 1]."""

    def fit(params, opt_state, sb, actions, target_r, target_c):
        names = list(params)
        losses = []
        for _ in range(regression_epochs):
            leaves = [params[k].detach().requires_grad_(True) for k in names]
            value = loss(dict(zip(names, leaves)), sb, actions, target_r, target_c)
            grads = clip_gradients_(list(torch.autograd.grad(value, leaves)))
            updates, opt_state = optimizer.update(grads, opt_state, [params[k] for k in names])
            params = dict(zip(names, apply_updates([params[k] for k in names], updates)))
            losses.append(value.detach())
        return params, opt_state, torch.stack(losses)

    return fit


class BudgetedFittedQ:
    def __init__(self, value_network, config, writer=None, generator: torch.Generator = None):
        self.config = config
        self.betas_for_duplication = parse_betas(config["betas_for_duplication"])
        self.network = value_network
        self.device = next(value_network.parameters()).device
        self.betas_for_discretisation = torch.as_tensor(
            parse_betas(config["betas_for_discretisation"]), device=self.device)
        self.n_actions = value_network.n_actions
        self.size_state = value_network.size_state
        self.writer = writer
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.loss = make_loss(value_network, self.n_actions,
                              loss_function_factory(config["loss_function"]),
                              loss_function_factory(config["loss_function_c"]),
                              config["weights_losses"])
        self.transitions: list = []
        self.batch = 0
        self.epoch = 0
        self.params = None
        self.opt_state = None
        self.optimizer = None
        self.reset()

    def push(self, state, action, reward, next_state, terminal, cost, beta=None):
        """Store with beta-duplication augmentation (bftq.py:53-74)."""
        state = np.asarray(state, np.float32).reshape(-1)
        next_state = np.asarray(next_state, np.float32).reshape(-1)
        if np.size(self.betas_for_duplication):
            for beta_d in self.betas_for_duplication:
                b = beta_d * beta if beta else beta_d
                self.transitions.append((state, action, reward, next_state, terminal, cost, b))
        else:
            self.transitions.append((state, action, reward, next_state, terminal, cost, beta))

    def _zip_batch(self) -> BFTQBatch:
        t = self.transitions

        def tensor(values, dtype):
            return torch.as_tensor(np.asarray(values, dtype=dtype), device=self.device)

        return BFTQBatch(
            state=tensor(np.stack([x[0] for x in t]), np.float32),
            action=tensor([x[1] for x in t], np.int64),
            reward=tensor([x[2] for x in t], np.float32),
            next_state=tensor(np.stack([x[3] for x in t]), np.float32),
            terminal=tensor([x[4] for x in t], bool),
            cost=tensor([x[5] for x in t], np.float32),
            beta=tensor([x[6] for x in t], np.float32),
        )

    def compute_targets(self, batch: BFTQBatch, bootstrap: bool):
        return compute_targets(self.network, self.params, batch, self.betas_for_discretisation,
                               bootstrap, self.config["gamma"], self.config["gamma_c"],
                               self.config.get("clamp_qc"))

    def run(self):
        """Fit (Qr, Qc) on the stored batch (bftq.py:76-101)."""
        self.batch += 1
        batch = self._zip_batch()
        sb = torch.cat([batch.state, batch.beta[:, None]], dim=1)
        for self.epoch in range(self.config["epochs"]):
            target_r, target_c = self.compute_targets(batch, self.epoch > 0)
            with torch.no_grad():
                delta = self.loss(self.params, sb, batch.action, target_r, target_c)
            if self.config["reset_network_each_epoch"]:
                self.reset_network()
            self.params, self.opt_state, losses = self._fit(
                self.params, self.opt_state, sb, batch.action, target_r, target_c)
            if self.writer:
                self.writer.add_scalar("agent/bellman_residual", float(delta), self.epoch)
                self.writer.add_scalar("agent/regression_loss", float(losses[-1]), self.epoch)
        return self.params

    def reset_network(self, params=None):
        """New parameters, drawn from the generator unless ``params`` are
        given, and a fresh optimizer state."""
        if params is None:
            params = model_params(init_parameters(self.network, self.generator))
        self.params = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
        self.opt_state = self.optimizer.init(list(self.params.values()))

    def reset(self, reset_weight: bool = True):
        self.optimizer = optimizer_factory(
            self.config["optimizer"]["type"],
            lr=self.config["optimizer"].get("learning_rate", 1e-3),
            weight_decay=self.config["optimizer"].get("weight_decay", 0.0))
        self._fit = make_fit(self.loss, self.optimizer, self.config["regression_epochs"])
        if reset_weight or self.params is None:
            self.reset_network()
        self.epoch = 0

    @property
    def memory_size(self):
        return len(self.transitions)
