"""Tree-search shell: receding-horizon loop + budget allocation.

Port of ``rl_agents_tpu/agents/tree_search/common.py`` (reference:
tree_search/abstract.py:15-106): ``plan()`` handles the receding-horizon
counter and delegates the search itself to a planner, a batch-first tensor
program over fixed-capacity node arenas. The agent's randomness is one
``torch.Generator`` on the agent's device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from rl_agents_torch.agents.base import AbstractAgent
from rl_agents_torch.factory import preprocess_env
from rl_agents_torch.utils.device import resolve_device


def olop_horizon(episodes: int, gamma: float) -> int:
    """L(M, gamma) (reference: olop.py:42-44)."""
    return max(int(np.ceil(np.log(episodes) / (2 * np.log(1 / gamma)))), 1)


def allocation(budget: int, gamma: float):
    """Split a budget into M episodes x horizon L (reference: olop.py:50-62)."""
    for episodes in range(1, int(budget)):
        if episodes * olop_horizon(episodes, gamma) > budget:
            episodes = max(episodes - 1, 1)
            return episodes, olop_horizon(episodes, gamma)
    raise ValueError(f"Could not split budget {budget} with gamma {gamma}")


def arena_subtree_gather(parent, children, used, action, out_capacity: int):
    """Compute the stable-gather compaction of the subtree rooted at the
    root's child for ``action`` in each of B node arenas (the array analog of
    the reference's step_by_subtree root-pointer move, abstract.py:194-206).

    ``parent`` is ``[B, N]``, ``children`` ``[B, N, A]`` and ``action`` an int
    or ``[B]``. Subtree membership is found by pointer doubling over parent
    links. Because parents always precede children in creation order, sibling
    blocks (the A children written by one expansion) are contiguous and
    uniform under the mask, so truncating at a block boundary when the subtree
    exceeds ``out_capacity`` keeps the tree well-formed.

    Returns ``(old_of_new, new_id, new_used, slot, valid)``:
    ``old_of_new [B, M]`` gathers old arena rows into the new arena (0 past
    the kept nodes), ``new_id [B, N]`` maps old ids to new ids (-1 if
    dropped), ``slot [B, M]`` marks allocated rows, ``valid [B]`` is False
    where the action was never explored from the root.
    """
    B, N, A = children.shape
    M = out_capacity
    device = parent.device
    idx = torch.arange(N, device=device).expand(B, N)
    # structural aliveness: arenas with episode-indexed slot bases are allowed
    # holes (slots never written), so ``idx < used`` is no membership test;
    # allocated non-root nodes always have a parent
    alive = (idx == 0) | (parent >= 0)
    del used
    action = torch.as_tensor(action, dtype=torch.int64, device=device).expand(B)
    new_root = children[:, 0].gather(1, action[:, None])
    valid = new_root.squeeze(1) >= 0

    mask = (idx == new_root) & alive
    jump = torch.where(parent >= 0, parent, idx)
    for _ in range(max(int(N).bit_length(), 1)):
        mask, jump = mask | mask.gather(1, jump), jump.gather(1, jump)
    mask = mask & alive

    rank = mask.cumsum(dim=1) - 1
    size = mask.sum(dim=1)
    cutoff = 1 + torch.div(size.clamp(max=M) - 1, A, rounding_mode="floor") * A
    kept = mask & (rank < cutoff[:, None])
    new_id = torch.where(kept, rank, -1)
    # the kept ids in order, padded with 0: dropped nodes write a spare column
    old_of_new = torch.zeros((B, M + 1), dtype=torch.int64, device=device)
    old_of_new.scatter_(1, torch.where(kept, rank, M), idx)
    old_of_new = old_of_new[:, :M].contiguous()
    new_used = kept.sum(dim=1)
    slot = torch.arange(M, device=device) < new_used[:, None]
    return old_of_new, new_id, new_used, slot, valid


class AbstractTreeSearchAgent(AbstractAgent):
    """Receding-horizon planning loop (reference: tree_search/abstract.py:15-106)."""

    def __init__(self, env, config=None, device="cuda"):
        super().__init__(config)
        self.env = env
        self.device = resolve_device(device)
        self.previous_actions: List[int] = []
        self.remaining_horizon = 0
        self.steps = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.last_plan_data = None  # planner outputs for introspection
        self.make_planner()

    @classmethod
    def default_config(cls):
        return {
            "budget": 500,
            "gamma": 0.8,
            "step_strategy": "reset",
            "env_preprocessors": [],
            "display_tree": False,
            "receding_horizon": 1,
            "terminal_reward": 0,
        }

    def make_planner(self):
        """Derive the planner's static sizes from this env/config."""
        raise NotImplementedError

    def planner_plan(self, env, observation) -> List[int]:
        """Run the planner on the (preprocessed) environment state."""
        raise NotImplementedError

    def plan(self, observation):
        self.steps += 1
        replanning_required = self.step(self.previous_actions)
        if replanning_required:
            # also honour the corpus's singular "env_preprocessor" spelling
            preprocessors = self.config["env_preprocessors"] \
                or self.config.get("env_preprocessor") or []
            env = preprocess_env(self.env, preprocessors)
            actions = self.planner_plan(env, observation)
        else:
            actions = self.previous_actions[1:]
        self.write_tree()
        self.previous_actions = actions
        return actions

    def step(self, actions):
        """Receding-horizon counter (reference: abstract.py:70-82)."""
        replanning_required = self.remaining_horizon == 0 or len(actions) <= 1
        if replanning_required:
            self.remaining_horizon = self.config["receding_horizon"] - 1
        else:
            self.remaining_horizon -= 1
        self.planner_step_tree(actions)
        return replanning_required

    def planner_step_tree(self, actions):
        """Tree-reuse hook (reference: abstract.py:172-206 step_tree). Default:
        no carried state, i.e. 'reset'; planners that re-root their arena
        override it."""

    def act(self, state):
        actions = self.plan(state)
        return actions[0]

    def reset(self):
        self.previous_actions = []
        self.remaining_horizon = 0
        self.steps = 0
        self.last_plan_data = None

    def seed(self, seed=None):
        if seed is not None:
            self.generator.manual_seed(seed)
        return [seed]

    def record(self, state, action, reward, next_state, done, info):
        pass

    def write_tree(self):
        """With ``display_tree``, plot tree 0 of the last plan to the writer
        (the step count as its epoch)."""
        if self.config.get("display_tree") and self.writer and self.last_plan_data is not None:
            from rl_agents_torch.graphics.tree_plot import TreePlot

            TreePlot(self.last_plan_data, max_depth=6).plot_to_writer(self.writer,
                                                                      epoch=self.steps)

    def get_plan_list(self, actions, length) -> List[int]:
        actions = actions.cpu().numpy()
        length = int(length)
        return [int(a) for a in actions[:max(length, 1)]]
