"""Tree visualisation from node arenas.

Port of ``rl_agents_tpu/graphics/tree_plot.py`` (reference:
tree_search/graphics.py:101-166): the expanded search tree drawn with
matplotlib as value-coloured edges, optionally pushed to a TensorBoard
writer. The port's arenas are batch-first ``[B, N, ...]``: the plot takes
tree 0's row to the host through ``convert.tree_to_numpy``. ``edges`` is
what ``plot`` draws, without matplotlib; matplotlib is imported only to
draw.
"""
from __future__ import annotations

import numpy as np
import torch

from rl_agents_torch.convert import tree_to_numpy


def _slice_rows(tree, index: int):
    return type(tree)(*(_slice_rows(t, index) if isinstance(t, tuple)
                        else t[index:index + 1] if isinstance(t, torch.Tensor) and t.dim() > 0
                        else t for t in tree))


def _drop_axis(arrays):
    return type(arrays)(*(_drop_axis(a) if isinstance(a, tuple)
                          else a[0] if np.ndim(a) > 0 else a for a in arrays))


def tree_row(tree, index: int = 0):
    """Tree ``index`` of a batch-first arena (a NamedTuple of ``[B, ...]``
    tensors, nested NamedTuples too) as the same NamedTuple of numpy arrays
    without the batch axis; only that row is copied to the host."""
    return _drop_axis(tree_to_numpy(_slice_rows(tree, index)))


def _node_value(tree, idx):
    for field in ("value_upper", "value", "value_lower", "d_value_upper"):
        arr = getattr(tree, field, None)
        if arr is not None:
            v = np.asarray(arr)
            if v.ndim == 1:
                return float(v[idx])
            return float(v[idx].min())
    return 0.0


class TreePlot:
    def __init__(self, tree, max_depth: int = 6):
        self.tree = tree_row(tree)
        self.max_depth = max_depth
        children = getattr(self.tree, "children", getattr(self.tree, "d_children", None))
        self.children = None
        if children is not None:
            # a decision/chance arena's ``d_children`` name chance nodes: ids
            # past the decision arena are dropped (the JAX package raises
            # IndexError there, ROADMAP.md §3)
            children = np.asarray(children)
            self.children = np.where(children < children.shape[0], children, -1)

    def edges(self, node=0, x=0.0, y=0.0, width=2.0, depth=0) -> list:
        """The edges ``plot`` draws, in its order: ``(x0, y0, x1, y1, value)``
        from a node to each of its children down to ``max_depth``, a child's
        value coloring its edge."""
        if depth > self.max_depth or self.children is None:
            return []
        valid = [int(c) for c in self.children[node] if c >= 0]
        out = []
        n = len(valid)
        for i, child in enumerate(valid):
            cx = x - width / 2 + (i + 0.5) * width / n
            cy = y - 1
            out.append((x, y, cx, cy, _node_value(self.tree, child)))
            out.extend(self.edges(child, cx, cy, width / n, depth + 1))
        return out

    def plot(self, ax, node=0, x=0.0, y=0.0, width=2.0, depth=0):
        import matplotlib.cm as cm

        for x0, y0, x1, y1, value in self.edges(node, x, y, width, depth):
            color = cm.jet(min(max(value / 5.0, 0.0), 1.0))
            ax.plot([x0, x1], [y0, y1], color=color, linewidth=1)

    def plot_to_writer(self, writer, epoch: int = 0, figsize=(8, 6), show=False):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        ax.axis("off")
        self.plot(ax)
        if writer is not None:
            try:
                writer.add_figure("planner/tree", fig, epoch)
            except AttributeError:
                pass
        if show:
            plt.show()
        plt.close(fig)
        return fig
