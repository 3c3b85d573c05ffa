"""Robust-agent visualisations.

Port of ``rl_agents_tpu/graphics/robust_graphics.py`` (reference:
robust/graphics/*.py): confidence-ellipsoid plots for EPC estimation and
interval-trajectory envelopes from the LPV predictor
(``robust/interval.py::lpv_trajectory``). Each figure's data comes from a
method that needs no matplotlib; matplotlib is imported only to draw.
"""
from __future__ import annotations

import numpy as np
import torch


def _add_figure(writer, tag: str, fig, epoch: int):
    if writer is not None:
        try:
            writer.add_figure(tag, fig, epoch)
        except AttributeError:
            pass


class RobustEPCGraphics:
    @classmethod
    def ellipsoid_curves(cls, agent, resolution: int = 60) -> list:
        """The curves ``display_ellipsoids`` draws, ``(xs, ys, alpha)``: about
        ten of the agent's confidence ellipsoids
        {theta : (theta - theta_hat)^T G (theta - theta_hat) <= beta^2}, as an
        interval at the update's height for a one-parameter model, else the
        ellipse of the first two parameters."""
        history = agent.ellipsoids[:: max(len(agent.ellipsoids) // 10, 1)]
        curves = []
        for i, (theta, g, beta) in enumerate(history):
            theta, g = np.asarray(theta), np.asarray(g)
            alpha = min(0.2 + 0.8 * i / max(len(history) - 1, 1), 1.0)
            if theta.shape[0] == 1:
                radius = beta / np.sqrt(max(float(np.ravel(g)[0]), 1e-9))
                curves.append(([theta[0] - radius, theta[0] + radius], [i, i], alpha))
            else:
                t = np.linspace(0, 2 * np.pi, resolution)
                circle = np.stack([np.cos(t), np.sin(t)])
                values, vectors = np.linalg.eigh(g[:2, :2])
                ell = theta[:2, None] + vectors @ np.diag(
                    beta / np.sqrt(np.maximum(values, 1e-9))) @ circle
                curves.append((ell[0], ell[1], alpha))
        return curves

    @classmethod
    def display_ellipsoids(cls, agent, writer=None, epoch: int = 0, resolution: int = 60):
        """Plot the evolution of the parameter confidence ellipsoids."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        one_parameter = np.asarray(agent.ellipsoids[0][0]).shape[0] == 1
        for xs, ys, alpha in cls.ellipsoid_curves(agent, resolution):
            if one_parameter:
                ax.plot(xs, ys, "-o", alpha=alpha, color="tab:blue", markersize=2)
            else:
                ax.plot(xs, ys, alpha=alpha, color="tab:blue")
        ax.set_xlabel("theta[0]")
        ax.set_ylabel("update" if one_parameter else "theta[1]")
        _add_figure(writer, "agent/ellipsoids", fig, epoch)
        plt.close(fig)
        return fig

    @classmethod
    def interval_envelope(cls, lpv, controls, dt):
        """``(lo, hi)``, each ``[T, p]`` numpy: the predictor's interval over
        ``controls`` (the first of a batch of intervals)."""
        from rl_agents_torch.robust.interval import lpv_trajectory

        controls = torch.as_tensor(np.asarray(controls, np.float32), device=lpv.x_lo.device)
        lo, hi = lpv_trajectory(lpv, controls, dt)
        lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        if lo.ndim == 3:
            lo, hi = lo[:, 0], hi[:, 0]
        return lo, hi

    @classmethod
    def display_interval_trajectory(cls, lpv, controls, dt, writer=None, epoch: int = 0):
        """Interval envelope of the predicted trajectory
        (the reference's interval overlays on the sim surface)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        lo, hi = cls.interval_envelope(lpv, controls, dt)
        steps = np.arange(lo.shape[0])
        fig, ax = plt.subplots()
        for dim in range(lo.shape[1]):
            ax.fill_between(steps, lo[:, dim], hi[:, dim], alpha=0.3,
                            label=f"x[{dim}] interval")
        ax.set_xlabel("step")
        ax.set_ylabel("state")
        ax.legend()
        _add_figure(writer, "agent/interval_trajectory", fig, epoch)
        plt.close(fig)
        return fig
