"""PyTorch/CUDA port of ``rl_agents_tpu``.

The JAX package beside this one is the reference. This package mirrors its
module layout and agent API (act/plan/record/seed) and reads the same JSON
config corpus (``scripts/configs/**``), with PyTorch idiom inside: state is
NamedTuples of tensors with a leading batch dimension, randomness comes from
``torch.Generator`` objects, and every entry point takes ``device=``
(default ``"cuda"``, which raises when no card is present).

Ported so far: the tree-search planners (KL-OLOP, MCTS, MDP-GapE, GBOP-D,
stochastic GBOP, OPD, state-aware OPD) and the robust planners on CartPole,
finite MDPs, Sailing and the highway family, and the DQN learner (the model
zoo, the optimizers, ``DQNAgent`` and the fused actor-learner), end to end
through ``factory``, ``trainer.evaluation`` and ``experiments``, with the KL
bound computed by the hand-written CUDA kernel ``csrc/kl_bound.cu``.
"""

__version__ = "0.1.0"
