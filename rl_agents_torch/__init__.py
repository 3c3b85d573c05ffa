"""PyTorch/CUDA port of ``rl_agents_tpu``.

The JAX package beside this one is the reference. This package mirrors its
module layout and agent API (act/plan/record/seed) and reads the same JSON
config corpus (``scripts/configs/**``), with PyTorch idiom inside: state is
NamedTuples of tensors with a leading batch dimension, randomness comes from
``torch.Generator`` objects, and every entry point takes ``device=``
(default ``"cuda"``, which raises when no card is present).

Ported so far: every planner and agent of the JAX package (tree search,
dynamic programming, the value-based learners, CEM, the robust planners, the
feedback controllers and the EPC agents) on every functional env (CartPole,
finite MDPs, Sailing, the highway family, MiniGrid, the grid and line
walks, the linear plants, classic control and parking, with the gymnasium
bridge for any other id), end to end through ``factory``,
``trainer.evaluation`` and ``experiments``, with the KL bound computed by
the hand-written CUDA kernel ``csrc/kl_bound.cu``.
"""

__version__ = "0.1.0"
