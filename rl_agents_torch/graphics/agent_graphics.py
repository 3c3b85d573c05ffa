"""Agent observability graphics.

Port of ``rl_agents_tpu/graphics/agent_graphics.py`` (reference:
common/graphics.py:20-51 isinstance dispatch; deep_q_network/graphics.py:10-164
value bars, attention heatmaps and value-function maps;
budgeted_ftq/graphics.py frontier plots). Host-side, off the planning path;
figures can go to a TensorBoard writer or be saved. Each figure's data comes
from a method that needs no matplotlib (``q_values``, ``attention_matrix``,
``q_table``, ``values_mesh``, ``frontier_points`` / ``frontier_of``);
matplotlib is imported
only to draw.
"""
from __future__ import annotations

import copy

import numpy as np
import torch


def _add_figure(writer, tag: str, fig, epoch: int):
    if writer is not None:
        try:
            writer.add_figure(tag, fig, epoch)
        except AttributeError:
            pass


class AgentGraphics:
    """isinstance-dispatch of agent visualisations (reference: common/graphics.py:20-51)."""

    @classmethod
    def display(cls, agent, writer=None, epoch: int = 0):
        from rl_agents_torch.agents.dqn.agent import DQNAgent
        from rl_agents_torch.agents.dynamic_programming.value_iteration import (
            ValueIterationAgent,
        )
        from rl_agents_torch.agents.robust.robust_epc import RobustEPCAgent
        from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent

        if isinstance(agent, DQNAgent):
            return DQNGraphics.display(agent, writer, epoch)
        elif isinstance(agent, ValueIterationAgent):
            return ValueIterationGraphics.display(agent, writer, epoch)
        elif isinstance(agent, RobustEPCAgent):
            from rl_agents_torch.graphics.robust_graphics import RobustEPCGraphics

            return RobustEPCGraphics.display_ellipsoids(agent, writer, epoch)
        elif isinstance(agent, AbstractTreeSearchAgent) and agent.last_plan_data is not None:
            from rl_agents_torch.graphics.tree_plot import TreePlot

            return TreePlot(agent.last_plan_data).plot_to_writer(writer, epoch)
        return None


class DQNGraphics:
    """Q-value bars + attention heatmap (reference: deep_q_network/graphics.py:10-90)."""

    @classmethod
    def q_values(cls, agent, state) -> np.ndarray:
        return np.asarray(agent.get_state_action_values(np.asarray(state)))

    @classmethod
    def display(cls, agent, writer=None, epoch: int = 0, state=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        state = state if state is not None else agent.previous_state
        if state is None:
            return None
        values = cls.q_values(agent, state)
        fig, ax = plt.subplots()
        ax.bar(range(len(values)), values)
        ax.set_xlabel("action")
        ax.set_ylabel("Q value")
        _add_figure(writer, "agent/q_values", fig, epoch)
        plt.close(fig)
        return fig

    @classmethod
    def attention_matrix(cls, agent, state):
        """Attention weights over entities for attention Q-networks
        (reference: compute_vehicles_attention, deep_q_network/graphics.py:92-130),
        from the agent's current parameters on the agent's device:
        ``[heads, ego, entities]`` as numpy, None for a network without
        attention."""
        model = agent.model
        if not hasattr(model, "get_attention_matrix"):
            return None
        # the agent's parameters live in its train state, not in the module
        model = copy.deepcopy(model)
        model.load_state_dict(agent.train_state.params, strict=False)
        x = torch.tensor(np.asarray(state, np.float32), device=agent.device)[None]
        with torch.no_grad():
            return model.get_attention_matrix(x)[0].cpu().numpy()


class ValueIterationGraphics:
    """Q-table heatmap for finite-MDP agents
    (reference: dynamic_programming/graphics.py:8-62)."""

    @classmethod
    def q_table(cls, agent) -> np.ndarray:
        q = agent.state_action_value
        return q.cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)

    @classmethod
    def display(cls, agent, writer=None, epoch: int = 0):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        q = cls.q_table(agent)
        fig, ax = plt.subplots()
        mesh = ax.pcolormesh(q.T, shading="auto", cmap="viridis")
        fig.colorbar(mesh, label="Q(s, a)")
        ax.set_xlabel("state")
        ax.set_ylabel("action")
        _add_figure(writer, "agent/q_table", fig, epoch)
        plt.close(fig)
        return fig


class ValueFunctionViewer:
    """Value maps over a state mesh (reference: deep_q_network/graphics.py:132-164
    + trainer/state_sampler.py)."""

    def __init__(self, agent, state_sampler):
        self.agent = agent
        self.sampler = state_sampler

    def values_mesh(self):
        """``(xx, yy, values)`` on the sampler's mesh, values shaped as ``xx``."""
        xx, yy, states = self.sampler.states_mesh()
        values, _ = self.agent.get_batch_state_values(states)
        return xx, yy, np.asarray(values).reshape(xx.shape)

    def plot_to_writer(self, writer=None, epoch: int = 0):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xx, yy, values = self.values_mesh()
        fig, ax = plt.subplots()
        mesh = ax.pcolormesh(xx, yy, values, shading="auto")
        fig.colorbar(mesh)
        _add_figure(writer, "agent/value_function", fig, epoch)
        plt.close(fig)
        return fig


class BFTQGraphics:
    """Pareto frontier plot (reference: budgeted_ftq/graphics.py:22-60)."""

    @classmethod
    def frontier_points(cls, agent, state) -> dict:
        """The agent's Q-values of ``state`` at the discretised budgets, from
        its network on its device, and their frontier (``frontier_of``)."""
        from torch.func import functional_call

        bftq = agent.bftq
        betas = bftq.betas_for_discretisation
        s = torch.as_tensor(np.asarray(state, np.float32).flatten(), device=betas.device)
        sb = torch.cat([s[None].expand(betas.shape[0], -1),
                        betas.to(torch.float32)[:, None]], dim=1)
        with torch.no_grad():
            q = functional_call(bftq.network, bftq.params, (sb,))
        return cls.frontier_of(q, betas)

    @classmethod
    def frontier_of(cls, q, betas) -> dict:
        """Q-values ``q [budgets, 2A]`` at the budgets ``betas``: the (Qc, Qr)
        cloud over budgets and actions, and its top frontier
        (``frontier_qc``, ``frontier_qr``, in Qc order), as numpy."""
        from rl_agents_torch.agents.budgeted_ftq.greedy_policy import (
            frontier_values,
            pareto_frontier,
        )

        qr, qc, actions, budgets = frontier_values(q[None], betas)
        f = pareto_frontier(qr, qc, actions, budgets)
        n = int(f.count[0])
        return {"q": q.cpu().numpy(), "qc": qc[0].cpu().numpy(), "qr": qr[0].cpu().numpy(),
                "frontier_qc": f.qc[0, :n].cpu().numpy(),
                "frontier_qr": f.qr[0, :n].cpu().numpy()}

    @classmethod
    def display_frontier(cls, agent, state, writer=None, epoch: int = 0):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        points = cls.frontier_points(agent, state)
        fig, ax = plt.subplots()
        ax.scatter(points["qc"], points["qr"], s=10, alpha=0.5, label="points")
        ax.plot(points["frontier_qc"], points["frontier_qr"], "r-o", label="frontier")
        ax.set_xlabel("Qc")
        ax.set_ylabel("Qr")
        ax.legend()
        _add_figure(writer, "agent/frontier", fig, epoch)
        plt.close(fig)
        return fig
