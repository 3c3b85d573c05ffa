"""Episode renderers and video recording for functional envs.

Port of ``rl_agents_tpu/graphics/render.py``. The reference wraps envs in
gymnasium's RecordVideo (evaluation.py:79-86); functional envs have no
viewer, so frames are drawn with matplotlib from the env state, collected per
episode and saved as GIFs on the same cubic schedule. Host-side, off the
planning path.

The port's env state is batch-first and may live on the card: what a frame
draws is read from row 0 of the handle's state through one host copy a
field (``cartpole_frame`` / ``highway_frame``, plain numpy, which
``pygame_viewer.py`` draws too). matplotlib is imported only to draw.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def state_row(handle, index: int = 0):
    """Row ``index`` of the handle's batch-first state as numpy."""
    state = handle.state
    return type(state)(*(v[index].cpu().numpy() for v in state))


def cartpole_frame(handle) -> dict:
    """What a CartPole frame draws: the cart's position and the pole's angle."""
    s = state_row(handle)
    return {"x": float(s.x), "theta": float(s.theta)}


def highway_frame(handle) -> dict:
    """What a highway frame draws: each vehicle's position, lane and
    presence, whether the ego crashed, and the road's lane count."""
    s = state_row(handle)
    return {"x": np.asarray(s.x), "lane": np.asarray(s.lane),
            "alive": np.asarray(s.alive, bool), "crashed": bool(np.any(s.crashed)),
            "lanes": int(handle.functional.lanes)}


def _fig_to_rgb(fig):
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[:, :, :3].copy()


class CartPoleRenderer:
    frame_data = staticmethod(cartpole_frame)

    def render(self, env_handle) -> np.ndarray:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        frame = cartpole_frame(env_handle)
        x, theta = frame["x"], frame["theta"]
        fig, ax = plt.subplots(figsize=(4, 3), dpi=80)
        ax.set_xlim(-2.6, 2.6)
        ax.set_ylim(-0.5, 1.5)
        ax.plot([-2.4, 2.4], [0, 0], "k-", linewidth=1)
        ax.add_patch(plt.Rectangle((x - 0.2, -0.1), 0.4, 0.2, color="tab:blue"))
        ax.plot([x, x + np.sin(theta)], [0.1, 0.1 + np.cos(theta)],
                color="tab:orange", linewidth=3)
        ax.axis("off")
        image = _fig_to_rgb(fig)
        plt.close(fig)
        return image


class HighwayRenderer:
    frame_data = staticmethod(highway_frame)

    def render(self, env_handle) -> np.ndarray:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        frame = highway_frame(env_handle)
        x, lane, lanes = frame["x"], frame["lane"], frame["lanes"]
        fig, ax = plt.subplots(figsize=(8, 2), dpi=80)
        x0 = x[0]
        ax.set_xlim(x0 - 30, x0 + 90)
        ax.set_ylim(-1, lanes)
        for l in range(lanes + 1):
            ax.plot([x0 - 30, x0 + 90], [l - 0.5, l - 0.5], "k--", linewidth=0.5)
        colors = ["tab:green"] + ["tab:blue"] * (len(x) - 1)
        if frame["crashed"]:
            colors[0] = "tab:red"
        for i in range(len(x)):
            ax.add_patch(plt.Rectangle((x[i] - 2.5, lane[i] - 0.3), 5.0, 0.6,
                                       color=colors[i]))
        ax.axis("off")
        image = _fig_to_rgb(fig)
        plt.close(fig)
        return image


def renderer_for(env_handle):
    env_id = getattr(getattr(env_handle, "spec", None), "id", "")
    if env_id == "cartpole":
        return CartPoleRenderer()
    if env_id in ("highway", "intersection"):
        return HighwayRenderer()
    return None


class EpisodeRecorder:
    """Collects frames during an episode and writes a GIF
    (the reference's RecordVideo analog, evaluation.py:79-86)."""

    def __init__(self, directory, name_prefix: str = "episode"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.name_prefix = name_prefix
        self.frames = []

    def capture(self, env_handle, renderer=None):
        renderer = renderer or renderer_for(env_handle)
        if renderer is None:
            return
        self.frames.append(renderer.render(env_handle))

    def save(self, episode: int, fps: int = 8):
        if not self.frames:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt

        path = self.directory / f"{self.name_prefix}-{episode}.gif"
        fig = plt.figure(figsize=(self.frames[0].shape[1] / 80,
                                  self.frames[0].shape[0] / 80), dpi=80)
        ax = fig.add_axes([0, 0, 1, 1])
        ax.axis("off")
        im = ax.imshow(self.frames[0])

        def update(i):
            im.set_data(self.frames[i])
            return [im]

        anim = animation.FuncAnimation(fig, update, frames=len(self.frames))
        anim.save(path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        self.frames = []
        return path
