"""Live pygame viewer with agent overlays.

Port of ``rl_agents_tpu/graphics/pygame_viewer.py``: the env viewer exposes
``set_agent_display`` and the evaluation loop hooks agent visualisations into
it each step (reference: trainer/evaluation.py:100-109); tree searches draw
value-coloured node rectangles (reference: tree_search/graphics.py:11-60) and
DQN agents draw Q-value bars (reference: deep_q_network/graphics.py:26-60).

Host-side and off the planning path: a frame reads row 0 of the handle's
batch-first state (``render.py``'s frame data) and tree 0 of a batch-first
arena (``tree_plot.tree_row``). Runs headless under ``SDL_VIDEODRIVER=dummy``
(surfaces only, no window). pygame is imported only by the viewer and the
overlays.
"""
from __future__ import annotations

import os

import numpy as np

from rl_agents_torch.graphics.render import cartpole_frame, highway_frame
from rl_agents_torch.graphics.tree_plot import tree_row


def _jet(v: float):
    """Value in [0,1] -> jet-like RGB (reference uses cmap('jet'))."""
    v = float(min(max(v, 0.0), 1.0))
    r = int(255 * min(max(1.5 - abs(4 * v - 3), 0), 1))
    g = int(255 * min(max(1.5 - abs(4 * v - 2), 0), 1))
    b = int(255 * min(max(1.5 - abs(4 * v - 1), 0), 1))
    return (r, g, b)


class PygameViewer:
    """Simulation surface + agent surface, reference-viewer-compatible.

    ``display(agent=...)`` draws the env into the sim surface, invokes the
    agent-display callback on the agent surface, and (when a real video
    driver is present) flips both to a window.
    """

    def __init__(self, env_handle, size=(640, 240), headless: bool | None = None):
        if headless is None:
            headless = not os.environ.get("DISPLAY")
        if headless:
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        import pygame

        pygame.init()
        self.pygame = pygame
        self.env = env_handle
        self.size = size
        self.sim_surface = pygame.Surface(size)
        self.agent_surface = pygame.Surface(size)
        self.agent_display = None
        self.screen = None
        if not headless:
            self.screen = pygame.display.set_mode((size[0], size[1] * 2))

    # -- reference protocol (evaluation.py:100-109)
    def set_agent_display(self, callback):
        self.agent_display = callback

    def display(self, agent=None):
        self._draw_env()
        if self.agent_display is not None:
            self.agent_surface.fill((20, 20, 20))
            self.agent_display(self.agent_surface, self.sim_surface)
        elif agent is not None:
            self.agent_surface.fill((20, 20, 20))
            default_agent_display(agent, self.agent_surface, self.sim_surface)
        if self.screen is not None:
            self.screen.blit(self.sim_surface, (0, 0))
            self.screen.blit(self.agent_surface, (0, self.size[1]))
            self.pygame.display.flip()
        return self.get_image()

    def get_image(self) -> np.ndarray:
        """[H, 2H_w, 3] uint8 frame (sim over agent surface)."""
        sim = self.pygame.surfarray.array3d(self.sim_surface).swapaxes(0, 1)
        ag = self.pygame.surfarray.array3d(self.agent_surface).swapaxes(0, 1)
        return np.concatenate([sim, ag], axis=0)

    def close(self):
        self.pygame.quit()

    # -- env drawing
    def _draw_env(self):
        name = type(self.env.functional).__name__
        if "Highway" in name or "Intersection" in name:
            self._draw_highway(highway_frame(self.env))
        elif "CartPole" in name:
            self._draw_cartpole(cartpole_frame(self.env))
        else:
            self.sim_surface.fill((40, 40, 40))

    def _draw_highway(self, frame: dict):
        pg = self.pygame
        W, H = self.size
        self.sim_surface.fill((100, 100, 100))
        lanes = frame["lanes"]
        lane_h = H / (lanes + 1)
        for i in range(lanes + 1):
            pg.draw.line(self.sim_surface, (255, 255, 255),
                         (0, int(i * lane_h + lane_h / 2)),
                         (W, int(i * lane_h + lane_h / 2)), 1)
        x = np.asarray(frame["x"], float)
        lane = np.asarray(frame["lane"], float)
        alive = frame["alive"]
        ego_x = x[0]
        scale = W / 120.0  # 120 m field of view, ego-centred at 1/3
        for v in range(len(x)):
            if not alive[v]:
                continue
            px = int((x[v] - ego_x) * scale + W / 3)
            py = int(lane[v] * lane_h + lane_h / 2 + lane_h * 0.15)
            color = (50, 200, 50) if v == 0 else (220, 200, 0)
            if v == 0 and frame["crashed"]:
                color = (230, 40, 40)
            pg.draw.rect(self.sim_surface, color,
                         pg.Rect(px - 8, py, 16, int(lane_h * 0.7)))

    def _draw_cartpole(self, frame: dict):
        pg = self.pygame
        W, H = self.size
        self.sim_surface.fill((255, 255, 255))
        x, theta = frame["x"], frame["theta"]
        cx = int(W / 2 + x * W / 9.6)
        cy = int(H * 0.75)
        pg.draw.line(self.sim_surface, (0, 0, 0), (0, cy + 12), (W, cy + 12), 2)
        pg.draw.rect(self.sim_surface, (60, 60, 200), pg.Rect(cx - 20, cy, 40, 12))
        tip = (int(cx + np.sin(theta) * H / 3), int(cy - np.cos(theta) * H / 3))
        pg.draw.line(self.sim_surface, (200, 120, 40), (cx, cy), tip, 5)


def tree_overlay(tree) -> tuple:
    """What the tree overlay draws of tree 0 of a batch-first arena:
    ``(children [N, A], values [N])``, or None without child pointers. The
    values are the first of ``value``, ``value_upper``, ``value_lower`` and
    ``d_value_upper`` the arena has (zeros when none); a child id past the
    values is -1."""
    row = tree_row(tree)
    children = getattr(row, "children", getattr(row, "d_children", None))
    if children is None:
        return None
    children = np.asarray(children)
    values = None
    for field in ("value", "value_upper", "value_lower", "d_value_upper"):
        arr = getattr(row, field, None)
        if arr is not None:
            values = np.asarray(arr)
            break
    if values is None:
        values = np.zeros(children.shape[0])
    if values.ndim == 2:
        values = values[:, 0]
    # a decision/chance arena's ``d_children`` name chance nodes, which index
    # no decision array: ids past it are dropped (the JAX package raises
    # IndexError there, ROADMAP.md §3)
    return np.where(children < values.shape[0], children, -1), values


class TreePygameGraphics:
    """Value-coloured node rectangles for array-arena trees
    (reference: tree_search/graphics.py:11-60 TreeGraphics.display)."""

    @classmethod
    def display(cls, agent, surface, max_depth: int = 6):
        import pygame as pg

        tree = getattr(agent, "last_plan_data", None)
        if tree is None:
            return
        overlay = tree_overlay(tree)
        if overlay is None:
            return
        children, values = overlay
        vmin, vmax = float(values.min()), float(values.max())
        span = (vmax - vmin) or 1.0
        W, H = surface.get_size()

        def rec(node, depth, y0, y1):
            if depth > max_depth:
                return
            x0 = W * depth / (max_depth + 1)
            color = _jet((float(values[node]) - vmin) / span)
            pg.draw.rect(surface, color,
                         pg.Rect(int(x0), int(y0), int(W / (max_depth + 1)) - 1,
                                 max(int(y1 - y0) - 1, 1)))
            kids = [int(c) for c in children[node] if c >= 0]
            if kids:
                h = (y1 - y0) / len(kids)
                for i, k in enumerate(kids):
                    rec(k, depth + 1, y0 + i * h, y0 + (i + 1) * h)

        rec(0, 0, 0, H)


class DQNPygameGraphics:
    """Q-value bars on the agent surface
    (reference: deep_q_network/graphics.py:26-60)."""

    @classmethod
    def display(cls, agent, surface):
        import pygame as pg

        state = getattr(agent, "previous_state", None)
        if state is None:
            return
        values = np.asarray(agent.get_state_action_values(np.asarray(state)))
        W, H = surface.get_size()
        n = len(values)
        vmin, vmax = float(values.min()), float(values.max())
        span = (vmax - vmin) or 1.0
        for a in range(n):
            frac = (float(values[a]) - vmin) / span
            bar_h = int(frac * (H - 20))
            x0 = int(a * W / n) + 4
            pg.draw.rect(surface, _jet(frac),
                         pg.Rect(x0, H - 10 - bar_h, int(W / n) - 8, bar_h))


def default_agent_display(agent, agent_surface, sim_surface):
    """isinstance dispatch onto pygame overlays
    (reference: common/graphics.py:20-51)."""
    from rl_agents_torch.agents.dqn.agent import DQNAgent
    from rl_agents_torch.agents.tree_search.common import AbstractTreeSearchAgent

    if isinstance(agent, DQNAgent):
        DQNPygameGraphics.display(agent, agent_surface)
    elif isinstance(agent, AbstractTreeSearchAgent):
        TreePygameGraphics.display(agent, agent_surface)
