"""Budgeted FTQ agent: risk-sensitive policies under cost budgets.

Port of ``rl_agents_tpu/agents/budgeted_ftq/agent.py`` (reference:
budgeted_ftq/agent.py:16-160, policies.py:20-96): actions and next budgets
are picked by mixing two Pareto-frontier points; exploration is
epsilon-greedy between the greedy budgeted policy and a random budgeted
policy whose budget allocation samples the simplex (common/utils.py:14-53).
Every draw comes from the host's numpy ``Generator``, the same stream as the
JAX package's agent; the network and the frontier run on the agent's device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.agents.budgeted_ftq.bftq import BudgetedFittedQ
from rl_agents_torch.agents.budgeted_ftq.greedy_policy import batch_mixtures
from rl_agents_torch.agents.budgeted_ftq.models import BudgetedMLP
from rl_agents_torch.utils.device import resolve_device


def sample_simplex(coeff, bias, min_x, max_x, np_random):
    """Sample x with coeff.x == bias, min_x <= x <= max_x
    (reference: common/utils.py:14-53; not uniform)."""
    coeff = np.asarray(coeff, dtype=float)
    x = np.zeros(len(coeff))
    indexes = np.arange(len(coeff))
    np_random.shuffle(indexes)
    remain = indexes.copy()
    for index in indexes:
        remain = remain[1:]
        if len(remain) == 0:
            break
        current_coeff = coeff[remain]
        dot_max = current_coeff @ np.full(len(remain), max_x)
        dot_min = current_coeff @ np.full(len(remain), min_x)
        min_xi = max((bias - dot_max) / coeff[index], min_x)
        max_xi = min((bias - dot_min) / coeff[index], max_x)
        xi = min_xi + np_random.random() * (max_xi - min_xi)
        bias -= xi * coeff[index]
        x[index] = xi
        if len(remain) == 1:
            break
    x[remain[0]] = bias / coeff[remain[0]]
    return x


class RandomBudgetedPolicy:
    """(reference: policies.py:46-58)"""

    def __init__(self, n_actions, np_random):
        self.n_actions = n_actions
        self.np_random = np_random

    def execute(self, state, beta):
        probs = self.np_random.random(self.n_actions)
        probs /= probs.sum()
        budgets = sample_simplex(coeff=probs, bias=beta, min_x=0, max_x=1,
                                 np_random=self.np_random)
        action = self.np_random.choice(self.n_actions, p=probs)
        return int(action), float(budgets[action])


class BudgetedFittedPolicy:
    """Greedy budgeted policy from the fitted (Qr, Qc) network
    (reference: policies.py:61-96)."""

    def __init__(self, bftq: BudgetedFittedQ, np_random):
        self.bftq = bftq
        self.np_random = np_random
        self.params = bftq.params

    def set_network(self, params):
        self.params = params

    def mixture(self, state, beta):
        """The mixture at one state and budget, read back to the host."""
        betas = self.bftq.betas_for_discretisation
        B = betas.shape[0]
        x = torch.as_tensor(np.asarray(state, np.float32), device=betas.device)
        sb = torch.cat([x[None].expand(B, -1), betas[:, None]], dim=1)
        with torch.no_grad():
            q = functional_call(self.bftq.network, self.params, (sb,))[None]  # [1, B, 2A]
        mix = batch_mixtures(q, betas, torch.tensor([beta], dtype=torch.float32,
                                                    device=betas.device))
        # one read-back for all nine fields (float64 holds the float32 values exactly)
        return type(mix)(*torch.stack([v[0].double() for v in mix]).tolist())

    def execute(self, state, beta):
        mix = self.mixture(state, beta)
        if self.np_random.random() < mix.probability_sup:
            return int(mix.action_sup), float(mix.budget_sup)
        return int(mix.action_inf), float(mix.budget_inf)


class EpsilonGreedyBudgetedPolicy:
    """(reference: policies.py:20-43)"""

    def __init__(self, pi_greedy, pi_random, config, np_random):
        self.pi_greedy = pi_greedy
        self.pi_random = pi_random
        self.config = config
        self.np_random = np_random
        self.time = 0

    def execute(self, state, beta):
        epsilon = self.config["final_temperature"] + \
            (self.config["temperature"] - self.config["final_temperature"]) * \
            np.exp(-self.time / self.config["tau"])
        self.time += 1
        if self.np_random.random() > epsilon:
            return self.pi_greedy.execute(state, beta)
        return self.pi_random.execute(state, beta)

    def set_time(self, time):
        self.time = time


class BFTQAgent(AbstractAgent):
    batched = True

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        if not self.config["epochs"]:
            self.config["epochs"] = int(1 / np.log(1 / self.config["gamma"]))
        self.env = env
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.np_random = np.random.default_rng()
        self.bftq = None
        self.exploration_policy = None
        self.beta = self.previous_beta = 0
        self.training = True
        self.previous_state = None
        self.reset()

    @classmethod
    def default_config(cls):
        return {
            "gamma": 0.9,
            "gamma_c": 0.9,
            "epochs": None,
            "delta_stop": 0.0,
            "memory_capacity": 10000,
            "beta": 0,
            "betas_for_duplication": "np.arange(0, 1, 0.1)",
            "betas_for_discretisation": "np.arange(0, 1, 0.1)",
            "exploration": {"temperature": 1.0, "final_temperature": 0.1, "tau": 5000},
            "optimizer": {"type": "ADAM", "learning_rate": 1e-3, "weight_decay": 1e-3},
            "loss_function": "l2",
            "loss_function_c": "l2",
            "regression_epochs": 500,
            "clamp_qc": None,
            "nn_loss_stop_condition": 0.0,
            "weights_losses": [1.0, 1.0],
            "split_batches": 1,
            "processes": 1,
            "samples_per_batch": 500,
            "batch_size": 100,
            "hull_options": {},
            "reset_network_each_epoch": True,
            "network": {
                "beta_encoder_type": "LINEAR",
                "size_beta_encoder": 10,
                "activation_type": "RELU",
                "layers": [64, 64],
            },
        }

    def act(self, state):
        """Pick the action and the next budget through the exploration policy;
        training draws a random initial budget each step (reference:
        agent.py:82-92)."""
        self.beta = float(self.np_random.uniform()) if self.training else self.config["beta"]
        state = np.asarray(state).flatten()
        self.previous_state, self.previous_beta = state, self.beta
        action, self.beta = self.exploration_policy.execute(state, self.beta)
        return action

    def record(self, state, action, reward, next_state, done, info):
        if not self.training:
            return
        cost = info.get("cost", 0.0) if isinstance(info, dict) else 0.0
        self.bftq.push(np.asarray(state).flatten(), action, reward,
                       np.asarray(next_state).flatten(), done, float(cost))

    def update(self):
        self.bftq.reset()
        params = self.bftq.run()
        self.exploration_policy.pi_greedy.set_network(params)

    def reset(self):
        network = BudgetedMLP(
            size_state=int(np.prod(self.env.observation_space.shape)),
            n_actions=self.env.action_space.n,
            layers=tuple(self.config["network"]["layers"]),
            size_beta_encoder=self.config["network"]["size_beta_encoder"],
            beta_encoder_type=self.config["network"]["beta_encoder_type"],
            activation_type=self.config["network"]["activation_type"]).to(self.device)
        self.bftq = BudgetedFittedQ(value_network=network, config=self.config,
                                    writer=self.writer, generator=self.generator)
        self.exploration_policy = EpsilonGreedyBudgetedPolicy(
            pi_greedy=BudgetedFittedPolicy(self.bftq, self.np_random),
            pi_random=RandomBudgetedPolicy(n_actions=self.env.action_space.n,
                                           np_random=self.np_random),
            config=self.config["exploration"],
            np_random=self.np_random)

    def set_time(self, time):
        self.exploration_policy.set_time(time)

    def seed(self, seed=None):
        self.np_random = np.random.default_rng(seed)
        if seed is not None:
            self.generator.manual_seed(seed)
        if self.exploration_policy is not None:
            self.exploration_policy.np_random = self.np_random
            self.exploration_policy.pi_greedy.np_random = self.np_random
            self.exploration_policy.pi_random.np_random = self.np_random
        return [seed]

    def save(self, filename):
        filename = Path(filename)
        filename.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in self.bftq.params.items()}, filename)
        return filename

    def load(self, filename):
        params = torch.load(filename, map_location=self.device, weights_only=True)
        self.bftq.reset_network(params)
        self.exploration_policy.pi_greedy.set_network(self.bftq.params)
        return filename

    def eval(self):
        self.training = False
        self.config["exploration"]["temperature"] = 0
        self.config["exploration"]["final_temperature"] = 0
        self.exploration_policy.config = self.config["exploration"]

    @property
    def memory(self):
        return self.bftq.transitions
