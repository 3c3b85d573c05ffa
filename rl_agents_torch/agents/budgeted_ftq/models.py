"""Budgeted Q-network: (state, budget) -> (Qr, Qc) per action.

Port of ``rl_agents_tpu/agents/budgeted_ftq/models.py`` (reference:
budgeted_ftq/models.py:6-57): the budget beta passes through its own encoder
(``LINEAR``: a dense layer without activation; ``REPEAT``: copies), is
concatenated with the state, and the head predicts ``2 * n_actions``
outputs, the Qr block then the Qc block. The submodules carry flax's names
(``beta_encoder``, ``Dense_<i>``, ``predict``), so that
``convert.flax_params_to_torch`` carries a JAX parameter tree across.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rl_agents_torch.models.zoo import Dense, activation_factory


class BudgetedMLP(nn.Module):
    def __init__(self, size_state: int, n_actions: int, layers: Sequence[int] = (64, 64),
                 size_beta_encoder: int = 10, beta_encoder_type: str = "LINEAR",
                 activation_type: str = "RELU"):
        super().__init__()
        if beta_encoder_type not in ("LINEAR", "REPEAT"):
            raise ValueError(f"Unknown encoder type: {beta_encoder_type}")
        self.size_state, self.n_actions = size_state, n_actions
        self.size_beta_encoder = size_beta_encoder
        self.beta_encoder_type = beta_encoder_type
        self.activation = activation_factory(activation_type)
        if size_beta_encoder > 1 and beta_encoder_type == "LINEAR":
            self.beta_encoder = Dense(1, size_beta_encoder)
        # the encoded beta, the raw beta (width 1) or none (width 0)
        width = size_state + max(size_beta_encoder, 0)
        self.n_hidden = len(layers)
        for i, size in enumerate(layers):
            self.add_module(f"Dense_{i}", Dense(width, size))
            width = size
        self.predict = Dense(width, 2 * n_actions)

    def forward(self, x):
        """``x [batch, size_state + 1]``, the budget beta in the last column."""
        state, beta = x[:, :-1], x[:, -1:]
        if self.size_beta_encoder > 1:
            if self.beta_encoder_type == "LINEAR":
                beta = self.beta_encoder(beta)
            else:
                beta = beta.repeat_interleave(self.size_beta_encoder, dim=1)
            h = torch.cat([state, beta], dim=1)
        elif self.size_beta_encoder == 1:
            h = x
        else:
            h = state
        for i in range(self.n_hidden):
            h = self.activation(getattr(self, f"Dense_{i}")(h))
        return self.predict(h)
