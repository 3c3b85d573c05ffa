#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rl_agents_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
non-zero without its final line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   no CUDA device is an error;
2. build the hand-written kernels from the repository's sources;
3. hold each kernel against its plain PyTorch version on the card, and time
   both: the KL bound's paired form ``kl_bounds_pair_`` on the arenas that
   MDP-GapE plans passed to it (recorded from the last episode of a
   4096-tree plan and of a 1-tree plan at the confidence 1.0 of
   ``mdp-gape.json``, and of a 4096-tree plan at the agent's default
   confidence 0.9) and that stochastic GBOP plans on Sailing (its reward sums
   are negative) and on highway passed to it, every entry off the path or
   the mask unchanged, timed beside the dense launches it replaces on the
   same inputs; the dense form ``kl_bound`` on those inputs, at n = 4096,
   1,000,003 and 2^24 on OLOP-like statistics and on edge cases; and the
   indexed form ``kl_bound_indexed_`` on a ``[4096, 369]`` arena at the
   planner's path of 8 x 4096 nodes;
4. the OLOP batch path at full width: ``olop_plan_batch`` on CartPole, 4096
   trees, 23 episodes x horizon 8, gamma 0.95, one ``kl_bound_indexed_``
   launch per episode, checked against the same first 64 trees planned on the
   CPU with the plain KL solve;
5. the OLOP agent path through the user's entry points: ``load_environment`` /
   ``load_agent`` / ``Evaluation.test`` for one CartPole episode on the card,
   cut to 3 steps (one ``kl_bound_indexed_`` launch per planning episode);
6. the MCTS batch path at full width: ``mcts_plan_batch`` on CartPole, 4096
   trees, 23 x 8, gamma 0.95, temperature 40, its first 64 trees checked
   against the CPU plan under the same noise; it launches no kernel;
7. the MCTS agent path: ``CartPoleEnv/MCTSAgent.json`` for one episode, cut to
   3 steps as the OLOP agent's;
8. the MDP-GapE batch path: ``mdp_gape_plan_batch``, 4096 trees on the garnet
   MDP of ``FiniteMDPEnv/env_garnet.json`` at the sizes of
   ``FiniteMDPEnv/agents/mdp-gape.json`` (confidence 1.0) and again at the
   agent's default confidence 0.9, one ``kl_bounds_pair_`` launch per
   episode (21 a plan; the dense form 0), the Newton trips of its chance
   backups counted,
   and the first 64 trees of a plan on a deterministic garnet checked against
   the CPU plan under the same noise (one timed plan, one with a read-back
   every Newton trip and one profiled at confidence 1.0; one timed plan, not
   profiled, at 0.9);
9. the MDP-GapE agent path: ``mdp-gape.json`` on ``env_garnet.json`` for one
   episode, cut to 3 steps;
10. the stochastic GBOP batch path: ``gbop_stochastic_plan_batch`` on the
    Sailing domain (``SailingEnv/env.json``, size 8), 4096 trees from random
    starts at the sizes of ``SailingEnv/agents/gbop.json`` (3 episodes x
    horizon 55, one next-state slot; one timed plan), one ``kl_bounds_pair_``
    launch per (episode, depth) step, 165 a plan, its value-iteration sweeps
    counted and
    its first 64 trees checked against the CPU plan under the same noise; then
    the same planner with three next-state slots on 512 trees, one plan, the Newton
    trips of its constrained expectations counted;
11. the GBOP-D batch path: ``gbop_plan_batch`` on Sailing, 4096 trees, 25
    expansions (``gbop-d.json``; one timed plan), its Bellman sweeps counted;
    no kernel;
12. the OPD batch path: ``opd_plan_batch`` on CartPole, 4096 trees, 115
    expansions; no kernel;
13. the Sailing agent paths: ``gbop.json``, ``gbop-d.json`` and ``opd.json`` on
    ``SailingEnv/env.json``, 3 steps each;
14. the highway batch paths at the full width of ``HighwayEnv/env.json`` (15
    vehicles on 4 lanes), at the JAX bench's sizes (``bench.py:242-367``):
    MCTS (4096 trees, 23 x 8), OPD (4096 trees, 46 expansions), GBOP-D (4096
    trees, 12 expansions), stochastic GBOP (512 trees, 8 x 4, 32
    ``kl_bounds_pair_`` launches a plan); KL-OLOP at ``kl-olop.json``'s budget (4096
    trees, 72 x 6, one ``kl_bound_indexed_`` launch per episode) and DROP on
    ``merge-v0`` (4096 trees x 2 models, 40 expansions); each timed, profiled
    (MCTS over 3 episodes of its 23) and its first 64 trees held against the
    CPU plan under the same noise;
15. the highway agent paths, 3 steps each: ``DeterministicPlannerAgent.json``,
    ``MCTSAgent.json``, ``OLOPAgent/kl-olop.json`` and
    ``IntervalRobustPlannerAgent/baseline.json`` on ``HighwayEnv/env.json``,
    and ``DiscreteRobustPlannerAgent.json`` on ``MergeEnv/env.json``;
16. the model zoo: the EgoAttentionNetwork at ``__graft_entry__.entry()``'s
    widths on the card against the same weights on the CPU (within 1e-5,
    its attention matrix too), at batch 8 and at the JAX bench's serving
    batch of 16,384 x 15 x 7, forwards timed by CUDA events in float32 and
    bfloat16; the TF32 flags printed;
17. the DQN agent path: ``HighwayEnv/agents/DQNAgent/ego_attention.json`` on
    the uncut ``HighwayEnv/env.json`` through ``load_environment``,
    ``load_agent`` and ``Evaluation(training=True).train()`` (8 episodes,
    one SGD step per ``record`` once the memory holds a batch, checkpoints
    written), one train step's gradients on the card against the CPU's
    (within 1e-5 of each leaf's largest entry), and a greedy ``test()``
    episode of at most 10 steps of an agent recovered from ``latest.tar``;
18. the fused actor-learner: the CUDA-graph step against the eager step
    from one seed; (a) DQN on CartPole at ``tests/test_dqn_curve_parity.py``'s
    settings (26,000 steps, 8 envs, one step in a CUDA graph), whose greedy
    mean over 64 episodes must reach the reference band's lower edge, 169.0;
    (b) the EgoAttentionNetwork learner at ``bench_dqn_ego_attention``'s
    sizes (highway 15 vehicles, 4 lanes; 64 envs, batch 64, capacity
    10,240), env-steps/s and a profiled short segment;
19. dynamic programming: ``ValueIterationAgent/baseline.json`` on the uncut
    ``HighwayEnv/env.json`` (its TTC view derived again at every act),
    ``SailingEnv/agents/vi.json`` on ``SailingEnv/env.json``, and
    ``RobustValueIterationAgent`` and ``ValueIterationAgent`` on
    ``FiniteMDPEnv/large``, 5-step episodes through ``Evaluation.test()``,
    each Q table on the card equal to the CPU's; the stochastic contraction
    on a seeded random MDP of 512 states within 1e-6 of the CPU's; seconds
    per act() and updates to convergence;
20. the MCTS-with-prior batch path at the JAX bench's MCTS-highway size:
    ``mcts_prior_plan_batch``, 4096 trees, 23 x 8, 15 vehicles on 4 lanes,
    the prior the DQN MLP [512, 512] of
    ``MCTSWithPriorPolicyAgent/baseline.json`` at temperature 0.5 with
    seeded weights, one forward on [4096, 75] at every expansion and rollout
    step, the forwards counted; 3 timed plans, a plan of 3 episodes
    profiled, the first 64 trees of a plan held against the CPU plan under
    the same noise;
21. the MCTS-with-prior agent paths, 3 steps each: ``baseline.json`` with its
    ``model_save`` pointing at a DQN checkpoint written here with
    ``DQNAgent.save``, and ``vi_prior.json`` with ``simplify``;
22. FTQ: ``HighwayEnv/agents/FTQAgent/baseline.json`` through
    ``Evaluation(training=True).train()`` for 71 episodes' worth of samples
    (one batch of 994, fitted once: 15 epochs x 100 regression steps, cut
    from the config's 400 for the time limit), ms per regression step and per
    ``update()``; then one epoch (100 steps under the same indices) on the
    card and on the CPU, in float32 and in float64, from
    fresh parameters and from the trained ones: the float64 epochs and the
    first step's float32 gradients within 1e-5 of each leaf's largest entry;
    the float32 epochs measured against each other and the float64 one, the
    double-DQN argmax differences counted;
23. BFTQ at ``bench_bftq_fit``'s sizes (S = 4096, D = 75, A = 3, 10 budgets,
    ``BudgetedMLP`` [64, 64], 50 ADAM steps): the targets on the card
    against the CPU's (mixture indices equal, values within 1e-5), one
    target computation plus fit epoch timed in states/s; then
    ``TwoWayEnv/agents/BFTQAgent/baseline.json`` at its width (100 budgets x
    5 actions, 500 hull points a state) through ``Evaluation.train()`` for
    one batch of 8 episodes, cut to 2 epochs x 100 regression steps (from
    15 x 5000), so that the second epoch bootstraps through the hull; its
    target computation profiled on 256 transitions, the first 8 of them
    held against the CPU (mixture indices equal, targets within 1e-5);
24. MCTS-DPW at ``MCTSDPWAgent``'s defaults (budget 100, gamma 0.95: 5
    episodes x horizon 16) on Sailing, 4096 trees, its first 64 against the
    CPU plan under the same draws;
25. closed-loop MCTS on the uncut highway at the bench's 4096 trees x 23 x
    8 (observations keyed in 8 slots an action), the first 64 against the
    CPU; ``MCTSAgent/closed_loop.json`` for 3 steps;
26. BRUE at ``SailingEnv/agents/brue.json`` (budget 200, horizon 55), 4096
    trees from the env's reset states (one timed plan; a one-episode plan,
    budget 1, profiled), the first 64 against the CPU under the same draws; the agent
    for 3 steps;
27. sparse sampling at ``FiniteMDPEnv/agents/sparse_sampling.json`` (C = 3,
    horizon 3) on the garnet, 4096 trees against 64 on the CPU; the agent
    for 3 steps;
28. CEM: ``CartPoleEnv/CEMAgent.json`` and ``HighwayEnv/agents/CEMAgent/
    cem.json``, 3 steps each, each plan against the CPU's under the same
    normals;
29. PlaTyPOOS: ``HighwayEnv/agents/PlaTyPOOSAgent/baseline.json``, 3 steps,
    each plan against a CPU agent's from the same state;
30. TrailBlazer: 512 lockstep instances on the loop MDP at an oracle budget
    of 500 (``bench.py:624-671``), plans/s and dispatches per plan, the first
    64 values against a CPU run;
31. PCG64: 2^16 raw draws (64 streams x 1,024), then bounded integers and
    doubles, bit-equal to numpy's ``Generator(PCG64)``; the MCTS, OLOP and
    OPD parity plans in float64 for 16 seeds against the same plans on the
    CPU (plans, counts and stream digits equal);
32. KL-OLOP on ``MiniGrid-Empty-16x16-v0`` (``GridWorld/empty.json``) at
    ``GridWorld/agents/kl-olop.json``'s 55 episodes x horizon 9, 4096 trees
    from seeded cells and headings, one ``kl_bound_indexed_`` launch per
    episode, the first 64 trees against the CPU plan under the same draws
    (phase 3 also holds the kernel against its plain version on three
    episodes' inputs of this plan); ``kl-olop.json`` on ``empty.json`` and
    ``uct.json`` on ``collect_stochastic.json``, 3 steps each;
33. MDP-GapE on ``DummyEnv/gridenv_stoch.json`` at ``DummyEnv/agents/
    mdp-gape.json``'s 35 (+1) x 5, 4096 trees, 36 ``kl_bounds_pair_``
    launches a plan, the first 64 trees against the CPU plan under the same
    draws (the grid's drops injected); ``mdp-gape.json`` on the grid and
    ``DummyEnv/agents/{kl-olop,brue}.json`` on ``dynamics.json``, 3 steps
    each;
34. ``MountainCarEnv/MCTSAgent.json``, ``Pendulum/{OLOPAgent,cem}.json`` and
    ``ParkingEnv/cem.json``, 3 steps each;
35. robust control: the interval predictor over 4096 interval states for 40
    steps against the CPU; ``ObstacleEnv/RobustEPCAgent.json`` for 3 steps,
    each action against a CPU agent's; ``ConstrainedEPCAgent`` at
    tests/agents/test_robust.py's configuration, 3 plans; ``LaneKeepingEnv/
    agents/linear.json`` for 3 steps; the LMI solves of tests/agents/
    test_lmi.py's systems on the card and the CPU (verdicts equal, times)
    and the host synchronisations of one descent step;
36. ``make_sharded_actor_learner`` on a one-rank NCCL group at
    ``__graft_entry__.py::dryrun_multichip``'s sizes (4 shards x 2 envs,
    rings of 64, 4 rows a shard, learning from 8): CartPole with a (64, 64)
    MLP for 12 steps and the EgoAttention flagship on highway (6 vehicles,
    3 lanes) for 8, tp off (one rank has no tp axis), each against the same
    segment on the CPU under the same injected draws (actions, terminals and
    counters equal, rewards within 1e-6, parameters within 1e-5), ms a step
    of a second segment, and a profiled step's all-reduce calls and NCCL
    kernels;
37. ``sharded_planner_batch`` over KL-OLOP on CartPole at phase 4's 4096
    trees x 23 x 8: 23 ``kl_bound_indexed_`` launches, actions equal to
    phase 4's unsharded plan;
38. serving: the greedy policy of phase 17's trained highway DQN exported
    with ``torch.export`` on the card, loaded with ``load_policy`` and served
    at batches of 1, 64 and 4096 (actions equal to the agent's, Q within
    1e-6), the export's seconds and ms a served batch;
39. a ``save_pytree`` / ``load_pytree`` round trip of phase 36's flagship
    state, bit-equal on the card; a ``trace()`` of one sharded step, its
    Chrome trace written; ``device_memory_stats()``;
40. MCTS on the stochastic garnet of ``env_garnet.json``, every draw
    injected (the env's too): ``mcts_plan_batch_fused`` at 4096 trees x 23 x
    8, and ``mcts_prior_plan`` under a per-state table and under a root
    vector, one timed plan each, the first 64 trees against the CPU plan
    (actions, counts and children equal, values within 1e-5);
41. ``FunctionalEnv.rollout`` and ``policy_rollout`` on CartPole (4096 x
    200) and the uncut highway (512 x 20), against the CPU under the same
    actions and draws (integer fields equal, floats within 1e-6 over the
    episodes' live steps);
42. the display path: an ``Evaluation`` test episode of the KL-OLOP agent on
    CartPole, 3 steps, with ``display_agent`` and ``display_rewards`` (8
    ``kl_bound_indexed_`` launches a step), each frame's data, tree 0's
    plotted edges and the reward history against the same episode on the
    CPU; phase 17's attention matrix against the CPU; phase 23's BFTQ
    network's (Qc, Qr) cloud against the CPU's, and the frontier of the
    card's cloud against the CPU's frontier of the same cloud. This host has
    neither matplotlib nor pygame, so the drawing itself is tested on the
    CPU;
43. a ``kernels`` JSON line (the three KL forms; the dense form is on no
    main path since the paired form took its two callers, and its
    launches there are asserted 0), then ``{"ok": true, "device": {...}}``
    as the last line. The DQN paths, the paths of phases 19-31, the robust control
    of phase 35, the learner, serving and checkpoints of phases 36-39 and
    phases 40 and 41 launch no hand kernel: their products, softmax, hull,
    interval predictor, LMI descent, collectives and env steps are tensor
    functions and NCCL calls, as the JAX package computes them outside any
    Pallas kernel.

Every path is driven with every kernel launch counter set to 0 just before
and read just after.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bandwidth, and f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations of csrc/kl_bound.cu counted from its source: one Newton trip
# (KL: 9 with its two logf, minus the divergence: 1, derivative: 5, step: 2,
# |dx|: 1) and the per-element set-up (mu, divergence, midpoint: 4)
KL_OPS_PER_TRIP = 18
KL_OPS_SETUP = 4
KL_TOLERANCE = 1e-5

TREES, EPISODES, HORIZON, GAMMA = 4096, 23, 8, 0.95
ARENA = 1 + EPISODES * HORIZON * 2  # nodes per tree of the CartPole plan (2 actions)
DENSE_LARGE = 1 << 24  # the dense form where bytes should bind
CPU_SUBSET = 64
AGENT_CONFIG = {"__class__": "OLOPAgent", "budget": 184, "gamma": GAMMA}
AGENT_MAX_STEPS = 3  # agent episodes are cut for the time limit (PERF.md §4)
GARNET_AGENT_STEPS = 3  # of the 20 of env_garnet.json
PLANS = 3  # timed plans of each batch path
# cut from 3 for the time limit (PERF.md §4): MDP-GapE at confidence 1.0
# (phase 8), stochastic GBOP (10) and GBOP-D (11) on Sailing
GAPE_PLANS = SAILING_PLANS = 1
# cut to one timed plan for the time limit (PERF.md §4): the highway batch
# paths (phase 14), the prior planner (20) and closed-loop MCTS (25)
HW_PLANS = PRIOR_PLANS = CLOSED_LOOP_PLANS = 1
CONFIGS = REPO / "scripts" / "configs"
MCTS_TEMPERATURE = 40.0
# MDP-GapE at the sizes of FiniteMDPEnv/agents/mdp-gape.json: budget 100 at
# gamma 0.7 is 20 episodes x horizon 5, two next-state slots, confidence 1.0,
# which gives an infinite reward threshold and a KL solve of one trip. Every
# MDP-GapE config of the corpus sets confidence 1; the agent's own default is
# 0.9, which makes the solve iterate, so the batch path is driven at both
GAPE = dict(num_actions=4, episodes=20, horizon=5, gamma=0.7, accuracy=0.0, confidence=1.0,
            transition_threshold_coeff=0.1, width=2)
GAPE_DEFAULT = dict(GAPE, confidence=0.9)
# (label, sizes, timed plans, a plan with a read-back every trip)
# (label, sizes, timed plans, a plan with a read-back every Newton trip,
# profiled): the 0.9 plan's 164k kernels took the profiler about half a minute
GAPE_CASES = (("mdp-gape.json, confidence 1.0", GAPE, GAPE_PLANS, True, True),
              ("agent default, confidence 0.9", GAPE_DEFAULT, 1, False, False))
GAPE_STATES = 16
# the planner runs while ``episode <= episodes``: episodes + 1 episodes, one
# paired launch each over the episode's path (both bounds of H x B nodes)
GAPE_KL_LAUNCHES = GAPE["episodes"] + 1
# The Sailing planner study (SailingEnv/env.json with agents/gbop.json,
# gbop-d.json, opd.json): budget 200 at gamma 0.99. Stochastic GBOP splits it
# into 3 episodes x horizon 55 with one next-state slot and the thresholds
# 1 log(3) and 0.1 log(3); GBOP-D and OPD into 200 / 8 actions = 25 expansions
SAILING_GAMMA, SAILING_BUDGET, SAILING_ACTIONS = 0.99, 200, 8
GBOP = dict(num_actions=SAILING_ACTIONS, episodes=3, horizon=55, gamma=SAILING_GAMMA,
            accuracy=1e-2, reward_threshold_coeff=1.0, transition_threshold_coeff=0.1, width=1)
# three next-state slots, the wind's three outcomes: no corpus config sets it
GBOP_WIDE = dict(GBOP, width=3)
GBOP_WIDE_TREES = 512
GBOP_KL_LAUNCHES = GBOP["episodes"] * GBOP["horizon"]  # one paired launch a step
GBOP_D = dict(num_actions=SAILING_ACTIONS, expansions=SAILING_BUDGET // SAILING_ACTIONS,
              gamma=SAILING_GAMMA, accuracy=1e-2)
# OPD on CartPole at the JAX bench's budget: 230 / 2 actions = 115 expansions
OPD = dict(num_actions=2, expansions=115, gamma=GAMMA)
SAILING_AGENT_STEPS = 3
# The highway family at the full width of HighwayEnv/env.json (15 vehicles, 4
# lanes, 40 steps) and 5 meta-actions. The JAX bench's highway lines
# (bench.py:242-367): MCTS at the headline's 23 x 8, OPD with 46 expansions
# and a plan of 8, GBOP-D with 12 expansions, stochastic GBOP on 512 trees at
# 8 episodes x horizon 4 with both threshold coefficients 2 (one next-state
# slot: 32 kl_bounds_pair_ launches a plan); KL-OLOP at kl-olop.json's budget
# 500 and gamma 0.7 (72 episodes x horizon 6, threshold 2 log(time), uniform
# continuation: one kl_bound_indexed_ launch per episode); DROP on merge-v0
# with the two models of MergeEnv/agents/DiscreteRobustPlannerAgent.json at its
# budget 200 (40 expansions) and gamma 0.9
HW_ACTIONS = 5
HW_MCTS = dict(num_actions=HW_ACTIONS, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA,
               temperature=MCTS_TEMPERATURE)
HW_OPD = dict(num_actions=HW_ACTIONS, expansions=46, gamma=GAMMA, plan_capacity=8)
HW_GBOP_D = dict(num_actions=HW_ACTIONS, expansions=12, gamma=GAMMA, accuracy=1e-2)
HW_GBOP = dict(num_actions=HW_ACTIONS, episodes=8, horizon=4, gamma=GAMMA, accuracy=1e-2,
               reward_threshold_coeff=2.0, transition_threshold_coeff=2.0)
HW_GBOP_TREES = 512
HW_GBOP_KL_LAUNCHES = HW_GBOP["episodes"] * HW_GBOP["horizon"]
HW_OLOP_BUDGET, HW_OLOP_GAMMA = 500, 0.7
HW_OLOP = dict(num_actions=HW_ACTIONS, episodes=72, horizon=6, gamma=HW_OLOP_GAMMA,
               threshold_coeff=2.0, continuation_uniform=True)
HW_DROP = dict(num_actions=HW_ACTIONS, expansions=200 // HW_ACTIONS, gamma=0.9)
HIGHWAY_AGENT_STEPS = 3
# MCTS on highway launches about 2,900 kernels an episode: its profiled
# plan runs a few episodes of the same trees. KL-OLOP's profiled plan runs 6
# of its 72 episodes (about 14k kernels): the profiler's count of its KL
# kernels is held to one an episode, and a whole plan's trace (165k kernels)
# lost half its records on an H100 (PERF.md §4)
HW_PROFILED_EPISODES = 3
HW_OLOP_PROFILED_EPISODES = 6
CPU = torch.device("cpu")

# the DQN learner: the flagship model at __graft_entry__.entry()'s widths and
# at the JAX bench's serving batch (bench.py:673-690, float32 here)
EGO_MODEL = dict(out=5, embedding_layers=(64, 64), others_embedding_layers=(64, 64),
                 output_layers=(64,), feature_size=64, heads=4)
ENTRY_BATCH, SERVING_BATCH = 8, 16384
MODEL_TOLERANCE = 1e-5
DQN_AGENT = CONFIGS / "HighwayEnv" / "agents" / "DQNAgent" / "ego_attention.json"
# two episodes of the uncut env end in crashes after about 23 steps, below
# the config's batch of 32: eight give the learner some tens of SGD steps
DQN_EPISODES = 8
DQN_TEST_STEPS = 10
# tests/test_dqn_curve_parity.py's exact settings, and its bar: the greedy
# mean over 64 episodes at least the reference band's mean less 2 sigma
CURVE = dict(total_steps=26_000, segment=1000, seed=0, num_envs=8, capacity=20_000,
             batch_size=100, gamma=0.99, eps_tau=6000.0, target_update=50)
CURVE_LAYERS = (100, 100)
CURVE_EPISODES = 64
GRAPH_CHECK_STEPS = 100
# bench.py:436-455: highway at 15 vehicles, 4 lanes, 40 steps; 64 envs
EGO_FUSED = dict(num_envs=64, batch_size=64, capacity=10_240)
EGO_FUSED_WARM, EGO_FUSED_STEPS, EGO_FUSED_PROFILED = 50, 100, 10
# slice 7: dynamic programming (5-step agent episodes; the stochastic
# contraction on a random MDP of 512 states), MCTS with the DQN prior of
# MCTSWithPriorPolicyAgent/baseline.json at the JAX bench's MCTS-highway size,
# FTQ (71 episodes' worth: one batch of 994 samples, as near_split(71 * 14,
# size_bins=1000) gives), BFTQ at bench_bftq_fit's sizes (bench.py:750-819)
# and the two-way BFTQAgent cut to 1 epoch
DP_AGENT_STEPS = 5
DP_STOCHASTIC_STATES = 512
DP_STOCHASTIC_REL = 1e-6
PRIOR_LAYERS, PRIOR_TEMPERATURE = (512, 512), 0.5
PRIOR_PROFILED_EPISODES = 3
FTQ_EPISODES = 71
FTQ_STEPS = 100  # regression steps an epoch, cut from baseline.json's 400 for the time limit
FTQ_WITNESS = (1, 10, 100)  # steps after which the epochs are compared
BFTQ_STATES, BFTQ_BUDGETS, BFTQ_REGRESSION = 4096, 10, 50
BFTQ_TOLERANCE = 1e-5
# the two-way agent: 2 epochs, so that the second bootstraps through the
# P = 500 hull over all 112 x 10 transitions of 8 episodes
BFTQ_AGENT_EPISODES, BFTQ_AGENT_EPOCHS, BFTQ_AGENT_REGRESSION = 8, 2, 100
BFTQ_PROFILED, BFTQ_HELD = 256, 8


STARTED = time.time()


def phase(title: str):
    print(f"== {title} (at {time.time() - STARTED:.1f} s)", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``reps`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def reset_launches():
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_indexed_, kl_bounds_pair_

    kl_bound.launches = kl_bound_indexed_.launches = kl_bounds_pair_.launches = 0


def read_launches() -> dict:
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_indexed_, kl_bounds_pair_

    return {"kl_bound": kl_bound.launches, "kl_bound_indexed_": kl_bound_indexed_.launches,
            "kl_bounds_pair_": kl_bounds_pair_.launches}


NO_LAUNCHES = {"kl_bound": 0, "kl_bound_indexed_": 0, "kl_bounds_pair_": 0}


def expect_launches(path: str, got: dict, kl_bound: int, kl_bound_indexed_: int,
                    kl_bounds_pair_: int = 0):
    want = {"kl_bound": kl_bound, "kl_bound_indexed_": kl_bound_indexed_,
            "kl_bounds_pair_": kl_bounds_pair_}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def timed_plans(plan, count: int = PLANS) -> list:
    """Milliseconds of each of ``count`` plans, by CUDA events."""
    times = []
    for _ in range(count):
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        plan()
        end_ev.record()
        torch.cuda.synchronize()
        times.append(start_ev.elapsed_time(end_ev))
    return times


def kl_inputs(n: int, rng: np.random.Generator, device):
    """OLOP-like node statistics: counts up to the episode count, sums of
    Bernoulli rewards, thresholds c*log(t)."""
    count = rng.integers(0, EPISODES + 1, n).astype(np.float32)
    total = np.floor(rng.random(n) * (count + 1)).astype(np.float32)
    thr = (4.0 * np.log(rng.integers(1, EPISODES + 1, n))).astype(np.float32)
    return tuple(torch.tensor(v, device=device) for v in (total, count, thr))


def kl_edge_inputs(device):
    total = [0.0, 0.0, 5.0, 0.0, 3.0, 0.5, 1e6, 7.0]
    count = [0.0, 3.0, 5.0, 4.0, 0.0, 1.0, 1e6 + 1, 7.0]
    thr = [2.0, 2.0, 2.0, 2.0, 2.0, float(np.log(10.0)), 0.0, 0.0]
    return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (total, count, thr))


def time_kernel(run_kernel, run_plain, per_graph: int, replays: int, eager: int, plain: int):
    """(device ms per launch, ms per eager call, plain version's ms per call).
    The device time comes from ``per_graph`` launches captured in a CUDA
    graph and replayed, so no host work sits between them; the eager call
    (wrapper and launch from Python) is timed beside it."""
    for _ in range(3):
        run_kernel()
    run_plain()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            run_kernel()
    graph.replay()
    ms = cuda_ms(graph.replay, replays) / per_graph
    return ms, cuda_ms(run_kernel, eager), cuda_ms(run_plain, plain)


def kl_bound_of(bytes_moved: int, _sum, count, threshold, lower: bool, iters: int):
    """(bound ms, "bytes" or "operations", f32 ops, Newton trips, lane use):
    the least time of a solve of these inputs. Trips are those the inputs
    need: none where the kernel skips the loop (n == 0, or a mean on its
    bound). Lane use is the share of the warps' trips that do work: element i
    runs on lane i % 32 of warp i // 32, and a warp takes as many trips as
    its longest lane."""
    from rl_agents_torch.ops.kl_bound import kl_bound_trips

    mu = _sum / torch.clamp(count, min=1.0)
    needed = (count != 0) & (mu != (0.0 if lower else 1.0))
    per_lane = torch.where(needed, kl_bound_trips(_sum, count, threshold, lower=lower,
                                                  iters=iters), 0).flatten()
    trips = int(per_lane.sum())
    per_lane = torch.nn.functional.pad(per_lane, (0, -per_lane.numel() % 32))
    lane_use = trips / max(32 * int(per_lane.view(-1, 32).amax(dim=1).sum()), 1)
    ops = trips * KL_OPS_PER_TRIP + count.numel() * KL_OPS_SETUP
    bytes_s, ops_s = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations", ops, trips,
            lane_use)


def garnet_case(dev, branching: int):
    """The garnet MDP of ``FiniteMDPEnv/env_garnet.json`` (``branching`` 2; 1
    makes it deterministic) on ``dev`` and ``TREES`` start states from a seed."""
    from rl_agents_torch.envs.base import params_to
    from rl_agents_torch.envs.finite_mdp import MDPState, garnet

    config = json.loads((CONFIGS / "FiniteMDPEnv" / "env_garnet.json").read_text())
    env, params = garnet(torch.Generator().manual_seed(config["seed"]), config["num_states"],
                         config["num_actions"], branching)
    start = np.random.default_rng(3).integers(0, GAPE_STATES, TREES)

    def states(device, n):
        return MDPState(s=torch.tensor(start[:n], device=device),
                        t=torch.zeros(n, dtype=torch.int64, device=device),
                        done=torch.zeros(n, dtype=torch.bool, device=device))

    return env, params_to(params, dev), states


def pair_calls(module, run, keep: int) -> tuple:
    """Run ``run()`` with ``module.kl_bounds_pair_`` recording each call's
    inputs as the planner passed them, ``(sum, count, at, threshold, mask)``
    (the arenas cloned: the planner goes on writing them). Returns the last
    ``keep`` calls and the number of calls."""
    calls, seen, inner = [], [0], module.kl_bounds_pair_

    def recording(ucb, lcb, _sum, count, at, threshold, mask=None, **rest):
        seen[0] += 1
        calls.append(tuple(None if v is None else v.clone()
                           for v in (_sum, count, at, threshold, mask)))
        del calls[:-keep]
        return inner(ucb, lcb, _sum, count, at, threshold, mask, **rest)

    module.kl_bounds_pair_ = recording
    try:
        run()
    finally:
        module.kl_bounds_pair_ = inner
    return calls, seen[0]


def gape_pair_calls(dev, kw: dict, trees: int) -> list:
    """The paired launch of the last episode of one MDP-GapE plan of
    ``trees`` trees (its highest counts), as the planner passed it."""
    from rl_agents_torch.agents.tree_search import mdp_gape

    env, params, states = garnet_case(dev, branching=2)
    calls, seen = pair_calls(mdp_gape, lambda: mdp_gape.mdp_gape_plan(
        env, params, states(dev, trees), torch.Generator(device=dev).manual_seed(11),
        device=dev, **kw), keep=1)
    if seen != kw["episodes"] + 1:
        raise AssertionError(f"an MDP-GapE plan made {seen} paired KL calls, "
                             f"expected {kw['episodes'] + 1}")
    return calls


def sailing_case(dev):
    """The Sailing domain of ``SailingEnv/env.json`` (size 8) on ``dev`` and
    ``TREES`` start states from a seed: random positions short of the goal
    and random winds."""
    from rl_agents_torch.envs.sailing import SailingEnv, SailingState

    config = json.loads((CONFIGS / "SailingEnv" / "env.json").read_text())
    env = SailingEnv(size=config["size"], max_episode_steps=20 * config["size"])
    rng = np.random.default_rng(4)
    pos = rng.integers(0, config["size"] - 1, (TREES, 2))
    wind = rng.integers(0, 8, TREES)

    def states(device, n):
        return SailingState(pos=torch.tensor(pos[:n], device=device),
                            wind=torch.tensor(wind[:n], device=device),
                            t=torch.zeros(n, dtype=torch.int64, device=device))

    return env, env.default_params(dev), states


def gbop_pair_calls(dev, env, params, states0, kw: dict, launches: int) -> list:
    """The paired launches of the last episode of one stochastic GBOP plan
    from ``states0``, one a depth, as the planner passed them. The plan must
    make ``launches`` calls."""
    from rl_agents_torch.agents.tree_search import graph_based_stochastic as gbop

    calls, seen = pair_calls(gbop, lambda: gbop.gbop_stochastic_plan(
        env, params, states0, env.observe(params, states0),
        torch.Generator(device=dev).manual_seed(12), device=dev, **kw), keep=kw["horizon"])
    if seen != launches:
        raise AssertionError(f"a stochastic GBOP plan made {seen} paired KL calls, "
                             f"expected {launches}")
    return calls


def gathered(_sum, count, at, threshold, mask):
    """What a paired call solves, in ``at``'s shape (element i of tree
    i % B): the sums, the counts as f32, the threshold of each, and whether
    its tree is kept by the mask."""
    trees = _sum.shape[0]
    per_tree = at.reshape(-1, trees).t()
    s = _sum.reshape(trees, -1).gather(1, per_tree).t().reshape(at.shape)
    n = count.reshape(trees, -1).gather(1, per_tree).t().reshape(at.shape)
    t = threshold[n] if threshold.dim() == 1 else threshold.expand(at.shape)
    keep = (torch.ones_like(at, dtype=torch.bool) if mask is None else mask.expand(at.shape))
    return s, n.to(torch.float32), t.contiguous(), keep


def sailing_gbop_pair_calls(dev) -> list:
    """The paired launches of the last episode of a ``TREES``-tree stochastic
    GBOP plan on Sailing, which pays -cost / worst in [-1, 0): the sums are
    negative."""
    env, params, states = sailing_case(dev)
    calls = gbop_pair_calls(dev, env, params, states(dev, TREES), GBOP, GBOP_KL_LAUNCHES)
    sums = torch.stack([gathered(*call)[0] for call in calls])
    print(f"stochastic GBOP on Sailing, last episode: {int((sums < 0).sum())} of {sums.numel()} "
          f"reward sums passed to kl_bounds_pair_ are negative")
    if not (sums < 0).any():
        raise AssertionError("no negative reward sum reached kl_bounds_pair_ on Sailing")
    return calls


def highway_gbop_pair_calls(dev) -> list:
    """The paired launches of the last episode of a stochastic GBOP plan on
    highway at the JAX bench's sizes (512 trees, 8 x 4)."""
    env, params, states = highway_case(dev)
    calls = gbop_pair_calls(dev, env, params(dev), states(dev, HW_GBOP_TREES), HW_GBOP,
                            HW_GBOP_KL_LAUNCHES)
    counts = torch.stack([gathered(*call)[1] for call in calls])
    print(f"stochastic GBOP on highway, last episode: {len(calls)} launches of "
          f"{calls[0][2].numel()} elements, counts up to {float(counts.max())!r}")
    return calls


def time_dense(label: str, inputs, n: int, lower: bool, reps, dev) -> dict:
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_torch
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS as ITERS

    ms, call_ms, plain_ms = time_kernel(
        lambda: kl_bound(*inputs, lower=lower, iters=ITERS, device=dev),
        lambda: kl_bound_torch(*inputs, lower=lower, iters=ITERS), *reps)
    # three f32 inputs read once, one f32 output written once
    bound_ms, bound_by, ops, trips, lane_use = kl_bound_of(16 * n, *inputs, lower, ITERS)
    print(f"kl_bound {label} n={n} lower={lower} iters={ITERS}: kernel {ms!r} ms on the device, "
          f"{call_ms!r} ms per eager call, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
          f"by {bound_by} ({16 * n} bytes, {ops} f32 ops over {trips} Newton trips, "
          f"lane use {lane_use!r}), {bound_ms / ms!r} of the bound")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                lane_use=lane_use, trips=trips)


def check_kl_bound(dev) -> dict:
    """The dense form against its plain version on OLOP-like statistics at
    OLOP's former per-depth shape, a large odd size and 2^24, and on the edge
    cases; timed at n = 4096 and n = 2^24 (bytes-bound). Phase 3 also holds
    it on the planners' recorded inputs (``check_kl_bounds_pair``). Since
    MDP-GapE and stochastic GBOP call the paired form, no main path launches
    it."""
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bound_torch
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = [(f"{n} OLOP-like", kl_inputs(n, rng, dev)) for n in (TREES, 1_000_003, DENSE_LARGE)]
    cases.append(("8 edge cases", kl_edge_inputs(dev)))
    for label, inputs in cases:
        for lower in (False, True):
            for iters in (24, NEWTON_MAX_ITERATIONS):
                got = kl_bound(*inputs, lower=lower, iters=iters, device=dev)
                want = kl_bound_torch(*inputs, lower=lower, iters=iters)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                print(f"kl_bound n={label} lower={lower} iters={iters}: "
                      f"max|kernel - plain| = {err!r}")
                if not err <= KL_TOLERANCE:
                    raise AssertionError(f"kl_bound disagrees with its plain version: {err!r}")
                worst = max(worst, err)
    del cases

    main = time_dense("OLOP-like", kl_inputs(TREES, rng, dev), TREES, False, (100, 20, 500, 20),
                      dev)
    large = time_dense("OLOP-like", kl_inputs(DENSE_LARGE, rng, dev), DENSE_LARGE, False,
                       (10, 5, 20, 3), dev)
    others = {f"{key}_n{DENSE_LARGE}": value for key, value in large.items()}
    return {"name": "kl_bound", "route": "cuda", "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, **main, "library_ms": None, "on_main_path": False, **others}


def pair_bound_of(call) -> tuple:
    """(bound ms, "bytes" or "operations", f32 ops, Newton trips, lane use,
    bytes) of one paired call: each kept element reads an 8 B offset, a 4
    B sum and an 8 B count and writes two 4 B bounds; the mask and the
    threshold (or its table) are read once. Trips are those the inputs need:
    none where a chain skips the loop (n == 0, or its interval is a point).
    A lane steps both chains until both froze, so a warp takes as many trips
    as its longest lane's longer chain; lane use is the share of the two
    chains' trips that do work."""
    from rl_agents_torch.ops.kl_bound import kl_bound_trips
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    _sum, count, at, threshold, mask = call
    s, n, t, keep = (v.flatten() for v in gathered(*call))
    mu = s / torch.clamp(n, min=1.0)
    live = keep & (n != 0)
    sides = [torch.where(live & (mu != point), kl_bound_trips(s, n, t, lower=lower,
                                                              iters=NEWTON_MAX_ITERATIONS), 0)
             for lower, point in ((False, 1.0), (True, 0.0))]
    trips = int(sides[0].sum() + sides[1].sum())
    loop = torch.nn.functional.pad(torch.maximum(*sides), (0, -s.numel() % 32))
    lane_use = trips / max(2 * 32 * int(loop.view(-1, 32).amax(dim=1).sum()), 1)
    elements = int(keep.sum())
    bytes_moved = 28 * elements + (0 if mask is None else mask.numel()) + 4 * threshold.numel()
    ops = trips * KL_OPS_PER_TRIP + elements * (2 * KL_OPS_SETUP - 2)
    bytes_s, ops_s = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations", ops, trips,
            lane_use, bytes_moved)


def time_pair(label: str, call, dev, reps=(100, 20, 500, 20)) -> dict:
    """The paired launch against the two dense launches per depth that it
    replaced (upper and lower of each row of ``at``), on the same inputs in
    the same run: device ms by CUDA-graph replay, ms per eager call."""
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bounds_pair_, kl_bounds_pair_torch_
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS as ITERS

    _sum, count, at, threshold, mask = call
    ucb, lcb = torch.full_like(_sum, -7.0), torch.full_like(_sum, 7.0)
    ms, call_ms, plain_ms = time_kernel(
        lambda: kl_bounds_pair_(ucb, lcb, _sum, count, at, threshold, mask),
        lambda: kl_bounds_pair_torch_(ucb, lcb, _sum, count, at, threshold, mask), *reps)
    s, n, t, keep = gathered(*call)
    rows = [tuple(v[h][keep[h]].contiguous() for v in (s, n, t)) for h in range(len(s))] \
        if at.dim() == 2 else [tuple(v[keep] for v in (s, n, t))]

    def dense():
        for row in rows:
            kl_bound(*row, iters=ITERS, device=dev)
            kl_bound(*row, lower=True, iters=ITERS, device=dev)

    dense_ms, dense_call_ms, _ = time_kernel(dense, lambda: None, reps[0], reps[1], reps[2], 1)
    # what the pair of chains costs beside one chain: each side alone over all
    # the entries in one dense launch, and the paired launch with no trip
    s, n, t = (v[keep] for v in (s, n, t))
    one_chain = [time_kernel(lambda: kl_bound(s, n, t, lower=lower, iters=ITERS, device=dev),
                             lambda: None, reps[0], reps[1], 1, 1)[0] for lower in (False, True)]
    floor_ms = time_kernel(lambda: kl_bounds_pair_(ucb, lcb, _sum, count, at, threshold, mask,
                                                   iters=0), lambda: None, reps[0], reps[1], 1,
                           1)[0]
    bound_ms, bound_by, ops, trips, lane_use, bytes_moved = pair_bound_of(call)
    print(f"kl_bounds_pair_ {label}, at {tuple(at.shape)}: kernel {ms!r} ms on the device, "
          f"{call_ms!r} ms per eager call, plain {plain_ms!r} ms; the {2 * len(rows)} dense "
          f"launches it replaced: {dense_ms!r} ms on the device, {dense_call_ms!r} ms eager; "
          f"bound {bound_ms!r} ms by {bound_by} ({bytes_moved} bytes, {ops} f32 ops over {trips} "
          f"Newton trips, lane use {lane_use!r}), {bound_ms / ms!r} of the bound; iters=0 "
          f"(launch, loads, stores) {floor_ms!r} ms; one dense launch over the same entries, "
          f"upper {one_chain[0]!r} ms, lower {one_chain[1]!r} ms")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, dense_ms=dense_ms,
                dense_call_ms=dense_call_ms, dense_launches=2 * len(rows), bound_ms=bound_ms,
                bound_by=bound_by, lane_use=lane_use, trips=trips, floor_ms=floor_ms,
                one_chain_upper_ms=one_chain[0], one_chain_lower_ms=one_chain[1])


def check_kl_bounds_pair(dev, dense: dict) -> dict:
    """The paired form against its plain version, exactly within
    ``KL_TOLERANCE``, on every call that MDP-GapE plans (the last episode's:
    4096 trees and 1 tree at the config's confidence 1.0, 4096 trees at the
    agent's default 0.9) and stochastic GBOP plans (every depth of the last
    episode: on Sailing, negative sums; on highway at the JAX bench's 512
    trees) made, iters 24 and 100; every entry off the path or the mask
    keeps its value. The dense form is held against the same plain solves on
    the same inputs (into ``dense``). Timed on the MDP-GapE calls and on the
    first and the last depth of the GBOP episodes, beside the dense launches
    they replaced."""
    from rl_agents_torch.ops.kl_bound import kl_bound, kl_bounds_pair_, kl_bounds_pair_torch_
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    recorded = {"MDP-GapE confidence 1.0, 4096 trees": gape_pair_calls(dev, GAPE, TREES),
                "MDP-GapE confidence 1.0, 1 tree": gape_pair_calls(dev, GAPE, 1),
                "MDP-GapE confidence 0.9, 4096 trees": gape_pair_calls(dev, GAPE_DEFAULT, TREES),
                "stochastic GBOP on Sailing": sailing_gbop_pair_calls(dev),
                "stochastic GBOP on highway": highway_gbop_pair_calls(dev)}
    worst = dense_worst = 0.0
    for label, calls in recorded.items():
        for i, call in enumerate(calls):
            _sum, count, at, threshold, mask = call
            written = torch.zeros(_sum.shape, dtype=torch.bool, device=dev)
            per_tree = at.reshape(-1, _sum.shape[0]).t()
            written.view(_sum.shape[0], -1).scatter_(1, per_tree, True)
            if mask is not None:
                written &= mask.reshape((-1,) + (1,) * (_sum.dim() - 1))
            s, n, t, keep = gathered(*call)
            for iters in (24, NEWTON_MAX_ITERATIONS):
                bases = (torch.full_like(_sum, -7.0), torch.full_like(_sum, 7.0))
                got = kl_bounds_pair_(*(b.clone() for b in bases), *call, iters=iters)
                want = kl_bounds_pair_torch_(*(b.clone() for b in bases), *call, iters=iters)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                untouched = all(torch.equal(g[~written], b[~written]) for g, b in zip(got, bases))
                # the dense form on the same entries, one launch a side
                dense_err = 0.0
                for lower, plain in ((False, want[0]), (True, want[1])):
                    solved = plain.view(_sum.shape[0], -1).gather(1, per_tree).t().reshape(at.shape)
                    out = kl_bound(s[keep], n[keep], t[keep], lower=lower, iters=iters, device=dev)
                    dense_err = max(dense_err, float((out - solved[keep]).abs().max()))
                print(f"kl_bounds_pair_ {label} call {i}, arena {tuple(_sum.shape)}, at "
                      f"{tuple(at.shape)}, iters={iters}: max|kernel - plain| = {err!r}, entries "
                      f"off the path or the mask unchanged: {untouched}; dense form on the same "
                      f"inputs: {dense_err!r}")
                expect(err <= KL_TOLERANCE and untouched,
                       f"kl_bounds_pair_ disagrees with its plain version: {err!r}, "
                       f"unchanged elsewhere: {untouched}")
                expect(dense_err <= KL_TOLERANCE,
                       f"kl_bound disagrees with its plain version: {dense_err!r}")
                worst, dense_worst = max(worst, err), max(dense_worst, dense_err)
    dense["max_abs_err"] = max(dense["max_abs_err"], dense_worst)

    timed = {}
    for label, tag in (("MDP-GapE confidence 1.0, 4096 trees", "gape_config"),
                       ("MDP-GapE confidence 1.0, 1 tree", "gape_config_n1"),
                       ("MDP-GapE confidence 0.9, 4096 trees", "gape_default")):
        timed[tag] = time_pair(label, recorded[label][0], dev)
    for label, tag in (("stochastic GBOP on Sailing", "gbop"),
                       ("stochastic GBOP on highway", "highway_gbop")):
        calls = recorded[label]
        timed[f"{tag}_first"] = time_pair(f"{label}, first depth", calls[0], dev)
        timed[f"{tag}_last"] = time_pair(f"{label}, last depth", calls[-1], dev)
    del recorded
    main = timed.pop("gape_config")
    others = {f"{key}_{tag}": value for tag, one in timed.items() for key, value in one.items()}
    return {"name": "kl_bounds_pair_", "route": "cuda",
            "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, **main, "library_ms": None, "on_main_path": True, **others}


def kl_arena(rng: np.random.Generator, device):
    """An OLOP-sized arena ``[TREES, ARENA]`` of OLOP-like statistics, a
    path ``[HORIZON, TREES]`` of distinct non-root nodes per tree and the
    threshold 4 log(EPISODES), as the planner hands them to the indexed form."""
    total, count, _ = kl_inputs(TREES * ARENA, rng, device)
    nodes = np.argsort(rng.random((TREES, ARENA - 1)), axis=1)[:, :HORIZON].T + 1
    return (total.reshape(TREES, ARENA), count.to(torch.int64).reshape(TREES, ARENA),
            torch.tensor(np.ascontiguousarray(nodes), device=device),
            torch.tensor(4.0 * np.log(EPISODES), dtype=torch.float32, device=device))


def check_kl_bound_indexed(dev) -> dict:
    """The indexed form against its plain version on an OLOP-sized arena,
    lower and upper, iters 24 and 100; entries off the path must stay as
    they were. Timed at the planner's 8 x 4096 path."""
    from rl_agents_torch.ops.kl_bound import kl_bound_indexed_, kl_bound_indexed_torch_
    from rl_agents_torch.utils.math import NEWTON_MAX_ITERATIONS

    rng = np.random.default_rng(2)
    total, count, nodes, thr = kl_arena(rng, dev)
    on_path = torch.zeros(total.shape, dtype=torch.bool, device=dev)
    on_path[torch.arange(TREES, device=dev).expand_as(nodes), nodes] = True
    base = torch.full(total.shape, -7.0, device=dev)
    worst = 0.0
    for lower in (False, True):
        for iters in (24, NEWTON_MAX_ITERATIONS):
            got = kl_bound_indexed_(base.clone(), total, count, nodes, thr, lower=lower,
                                    iters=iters)
            want = kl_bound_indexed_torch_(base.clone(), total, count, nodes, thr, lower=lower,
                                           iters=iters)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            untouched = torch.equal(got[~on_path], base[~on_path])
            print(f"kl_bound_indexed_ arena {TREES}x{ARENA} path {HORIZON}x{TREES} lower={lower} "
                  f"iters={iters}: max|kernel - plain| = {err!r}, off-path entries unchanged: "
                  f"{untouched}")
            if not (err <= KL_TOLERANCE and untouched):
                raise AssertionError(f"kl_bound_indexed_ disagrees with its plain version: "
                                     f"{err!r}, off-path unchanged: {untouched}")
            worst = max(worst, err)

    # the inputs of three episodes of a 4096-tree KL-OLOP plan on MiniGrid
    # (slice 9's path; the grid's terminal rewards are zeroed, so every sum is 0)
    for episode, (inputs, kwargs) in zip(MG_RECORDED, minigrid_kl_calls(dev)):
        for iters in (24, NEWTON_MAX_ITERATIONS):
            args = dict(kwargs, iters=iters)
            got = kl_bound_indexed_(inputs[0].clone(), *inputs[1:], **args)
            want = kl_bound_indexed_torch_(inputs[0].clone(), *inputs[1:], **args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"kl_bound_indexed_ MiniGrid OLOP episode {episode} arena "
                  f"{tuple(inputs[1].shape)} path {tuple(inputs[3].shape)} iters={iters}: "
                  f"max|kernel - plain| = {err!r}")
            expect(err <= KL_TOLERANCE, f"kl_bound_indexed_ disagrees on MiniGrid: {err!r}")
            worst = max(worst, err)

    out = base.clone()
    ms, call_ms, plain_ms = time_kernel(
        lambda: kl_bound_indexed_(out, total, count, nodes, thr, iters=NEWTON_MAX_ITERATIONS),
        lambda: kl_bound_indexed_torch_(out, total, count, nodes, thr,
                                        iters=NEWTON_MAX_ITERATIONS), 100, 20, 500, 20)
    # no Newton trip: what the launch, index loads, gathers and scatter cost
    floor_ms = time_kernel(lambda: kl_bound_indexed_(out, total, count, nodes, thr, iters=0),
                           lambda: None, 100, 20, 1, 1)[0]
    rows = torch.arange(TREES, device=dev).expand_as(nodes)
    elements = nodes.numel()
    # an 8 B index, an 8 B count and a 4 B sum read once, a 4 B bound written once
    bytes_moved = 24 * elements
    bound_ms, bound_by, ops, trips, lane_use = kl_bound_of(
        bytes_moved, total[rows, nodes], count[rows, nodes].to(torch.float32), thr, False,
        NEWTON_MAX_ITERATIONS)
    print(f"kl_bound_indexed_ {elements} path nodes, iters={NEWTON_MAX_ITERATIONS}: kernel {ms!r} "
          f"ms on the device, {call_ms!r} ms per eager call, plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms by {bound_by} ({bytes_moved} bytes, {ops} f32 ops over {trips} Newton "
          f"trips, lane use {lane_use!r}), {bound_ms / ms!r} of the bound")
    print(f"kl_bound_indexed_ {elements} path nodes, iters=0 (launch, loads, gathers and "
          f"scatter, no Newton trip): {floor_ms!r} ms on the device")
    return {"name": "kl_bound_indexed_", "route": "cuda",
            "source": "rl_agents_torch/csrc/kl_bound.cu",
            "replaces": "rl_agents_tpu/ops/pallas_kl.py:40", "launches": None,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "call_ms": call_ms, "on_main_path": True}


def profile_plan(plan, host_events: bool = True) -> dict:
    """Device busy share of one plan and its costliest device kernels, from
    torch.profiler's CUDA activity. ``host_events=False`` leaves the host's
    operators out of the trace, for a plan of several hundred thousand
    launches. Returns the device kernels and the KL kernel's milliseconds and
    launches; a trace without device time is an error."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_events else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        started = time.perf_counter()
        plan()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - started) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # kernels attributed to the host ops that launched them
        kernels = [e for e in events if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if busy_us <= 0:
        raise AssertionError("profiled plan: the profiler recorded no device time")
    print(f"profiled plan: {wall_us / 1e3!r} ms wall, device busy {busy_us / 1e3!r} ms "
          f"({busy_us / wall_us!r} of wall), {launches} device kernels")
    kl = [e for e in kernels if "kl_bound" in e.key]
    print(f"  KL kernel: {sum(e.self_device_time_total for e in kl) / 1e3!r} ms in "
          f"{sum(e.count for e in kl)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3!r} ms in {e.count} x {e.key[:90]}")
    return {"kernels": launches, "kl_ms": sum(e.self_device_time_total for e in kl) / 1e3,
            "kl_launches": sum(e.count for e in kl), "busy_share": busy_us / wall_us,
            "wall_ms": wall_us / 1e3}


def cartpole_case(dev):
    """CartPole and ``TREES`` start states, uniform in +-0.05, from a seed."""
    from rl_agents_torch.envs.cartpole import CartPoleEnv, CartPoleState

    env = CartPoleEnv(max_episode_steps=200)
    start = np.random.default_rng(1).uniform(-0.05, 0.05, (4, TREES)).astype(np.float32)

    def states(device, n):
        return CartPoleState(*(torch.tensor(v[:n], device=device) for v in start),
                             t=torch.zeros(n, dtype=torch.int64, device=device),
                             done=torch.zeros(n, dtype=torch.bool, device=device))

    return env, env.default_params(dev), states


def report_plans(name: str, times: list, work: int, unit: str) -> float:
    ms = statistics.median(times)
    print(f"{name}: median {ms!r} ms per plan over {[round(t, 3) for t in times]}, "
          f"{work / (ms / 1e3)!r} {unit}/s")
    return ms


def same_on_cpu(name: str, got: dict, want: dict, exact: tuple, close: tuple,
                subset: int = CPU_SUBSET):
    """The first ``subset`` trees of a plan on the card against the same
    trees planned on the CPU: ``exact`` fields equal, ``close`` within
    ``KL_TOLERANCE`` (infinities in the same places)."""
    for field in exact:
        if not np.array_equal(got[field][:subset], want[field]):
            raise AssertionError(f"{name}: {field} differs from the CPU plan")
    errors = {}
    for field in close:
        a, b = got[field][:subset], want[field]
        if not np.array_equal(np.isinf(a), np.isinf(b)):
            raise AssertionError(f"{name}: {field} is infinite elsewhere than in the CPU plan")
        finite = np.isfinite(b)
        errors[field] = float(np.abs(a[finite] - b[finite]).max()) if finite.any() else 0.0
    if not all(err <= KL_TOLERANCE for err in errors.values()):
        raise AssertionError(f"{name}: differs from the CPU plan by {errors}")
    print(f"{name}: first {subset} trees equal to the CPU plan ({', '.join(exact)}); "
          f"max|diff| {errors}")


def plan_fields(actions, lengths, tree) -> dict:
    from rl_agents_torch.convert import tree_to_numpy

    return dict(tree_to_numpy(tree)._asdict(), actions=actions.cpu().numpy(),
                lengths=lengths.cpu().numpy())


def check_olop_batch_path(dev) -> dict:
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch

    env, params, states = cartpole_case(dev)
    kw = dict(num_actions=2, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA, threshold_coeff=4.0)
    states0 = states(dev, TREES)
    plan = lambda: olop_plan_batch(env, params, states0, device=dev, **kw)
    plan()  # warm-up
    reset_launches()
    times = timed_plans(plan)
    launches = read_launches()
    expect_launches(f"OLOP batch path, {PLANS} plans", launches, 0, PLANS * EPISODES)
    report_plans(f"olop_plan_batch B={TREES} episodes={EPISODES} horizon={HORIZON}", times,
                 TREES * EPISODES * HORIZON, "env-steps")
    print(f"  {launches['kl_bound_indexed_'] // PLANS} kl_bound_indexed_ launches per plan")
    profile_plan(plan)

    got = plan_fields(*plan())
    if not (((got["actions"] >= 0) & (got["actions"] < 2)) | (got["actions"] == -1)).all() \
            or not ((got["lengths"] >= 1) & (got["lengths"] <= HORIZON)).all() \
            or not np.isfinite(got["value_upper"]).all():
        raise AssertionError("batch plan produced invalid actions, lengths or bounds")
    cpu = torch.device("cpu")
    want = plan_fields(*olop_plan_batch(env, env.default_params(cpu), states(cpu, CPU_SUBSET),
                                        device=cpu, **kw))
    same_on_cpu("olop_plan_batch", got, want, ("actions", "lengths", "parent", "count"),
                ("value_upper",))
    return launches, got["actions"]


def check_mcts_batch_path(dev) -> dict:
    """``mcts_plan_batch`` at the JAX bench's headline sizes; it launches no
    hand-written kernel (the JAX package computes MCTS outside any Pallas
    kernel too)."""
    from rl_agents_torch.agents.tree_search.batch import mcts_plan_batch
    from rl_agents_torch.agents.tree_search.mcts import gumbel

    env, params, states = cartpole_case(dev)
    probs = torch.ones(2) / 2
    kw = dict(num_actions=2, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA,
              temperature=MCTS_TEMPERATURE)
    states0 = states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: mcts_plan_batch(env, params, states0, generator, probs, probs, device=dev, **kw)
    plan()  # warm-up
    reset_launches()
    times = timed_plans(plan)
    launches = read_launches()
    expect_launches(f"MCTS batch path, {PLANS} plans", launches, 0, 0)
    report_plans(f"mcts_plan_batch B={TREES} episodes={EPISODES} horizon={HORIZON} "
                 f"temperature={MCTS_TEMPERATURE}", times, TREES * EPISODES * HORIZON, "env-steps")
    profile_plan(plan)

    # the same noise on both devices: drawn once on the CPU
    noise = gumbel((EPISODES, HORIZON, 2, 2, TREES), torch.Generator().manual_seed(5), "cpu")
    got = plan_fields(*mcts_plan_batch(env, params, states0, None, probs, probs, noise=noise,
                                       device=dev, **kw))
    if not ((got["lengths"] >= 1) & (got["lengths"] <= HORIZON)).all() \
            or not (got["count"][:, 0] == EPISODES).all() or not np.isfinite(got["value"]).all():
        raise AssertionError("MCTS batch plan produced invalid lengths, root counts or values")
    cpu = torch.device("cpu")
    want = plan_fields(*mcts_plan_batch(
        env, env.default_params(cpu), states(cpu, CPU_SUBSET), None, probs, probs,
        noise=noise[..., :CPU_SUBSET], device=cpu, **kw))
    same_on_cpu("mcts_plan_batch", got, want, ("actions", "lengths", "count", "parent"),
                ("value",))
    return launches


def reset_newton():
    from rl_agents_torch.utils.math import newton_iteration

    newton_iteration.calls = newton_iteration.trips = 0


def newton_line() -> str:
    from rl_agents_torch.utils.math import newton_iteration as newton

    return (f"{newton.calls} Newton solves of max_expectation_under_constraint, {newton.trips} "
            f"trips ({newton.trips / max(newton.calls, 1)!r} per solve)")


def check_gape_batch_path(dev) -> dict:
    """``mdp_gape_plan_batch`` on the stochastic garnet at the config's
    confidence and at the agent's default: timed, its KL launches counted and
    their device time read from the profiler, the Newton trips of its chance
    backups counted (as run, in blocks, and as needed, read back every trip);
    then one plan of each on the deterministic garnet against the CPU under
    the same noise. Returns the launches of the config's plans."""
    from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch
    from rl_agents_torch.agents.tree_search.mcts import gumbel
    from rl_agents_torch.convert import tree_to_numpy
    from rl_agents_torch.utils import math as port_math

    steps = TREES * (GAPE["episodes"] + 1) * GAPE["horizon"]
    cpu = torch.device("cpu")
    noise = gumbel((GAPE["episodes"] + 1, GAPE["horizon"], TREES, GAPE["num_actions"]),
                   torch.Generator().manual_seed(6), "cpu")
    fields = lambda best, used, tree: dict(tree_to_numpy(tree)._asdict(), best=best.cpu().numpy(),
                                           episodes_used=used.cpu().numpy())
    config_launches = None
    for label, kw, plans, read_back, profiled_plan in GAPE_CASES:
        print(f"-- {label}")
        env, params, states = garnet_case(dev, branching=2)
        states0 = states(dev, TREES)
        generator = torch.Generator(device=dev).manual_seed(0)
        plan = lambda: mdp_gape_plan_batch(env, params, states0, generator, device=dev, **kw)
        # no warm-up plan: phase 3 ran this planner at these shapes already
        reset_launches()
        reset_newton()
        times = timed_plans(plan, plans)
        launches = read_launches()
        expect_launches(f"MDP-GapE batch path, {plans} plans", launches, 0, 0,
                        plans * GAPE_KL_LAUNCHES)
        config_launches = config_launches or launches
        report_plans(f"mdp_gape_plan_batch B={TREES} episodes={kw['episodes']} (+1) "
                     f"horizon={kw['horizon']} width={kw['width']} confidence={kw['confidence']}",
                     times, steps, "env-steps")
        print(f"  {launches['kl_bounds_pair_'] // plans} kl_bounds_pair_ launches per plan "
              f"(the dense form: {launches['kl_bound']}); {plans} plans: "
              f"{newton_line()}, "
              f"in blocks of {port_math.NEWTON_BLOCK}")
        if read_back:  # the trips the data needs: the same plan, a read-back every trip
            block, port_math.NEWTON_BLOCK = port_math.NEWTON_BLOCK, 1
            try:
                reset_newton()
                ms = timed_plans(plan, 1)[0]
            finally:
                port_math.NEWTON_BLOCK = block
            print(f"  one plan with a read-back every trip: {ms!r} ms, {newton_line()}")
        if profiled_plan:
            results = []
            profiled = profile_plan(lambda: results.append(plan()), host_events=False)
            if profiled["kl_launches"] != GAPE_KL_LAUNCHES:
                raise AssertionError(f"the profiler saw {profiled['kl_launches']} KL kernels in "
                                     f"one plan, expected {GAPE_KL_LAUNCHES}")
            best, used, tree = results[0]
        else:
            best, used, tree = plan()
        if not ((best >= 0) & (best < kw["num_actions"])).all() \
                or not (used == kw["episodes"] + 1).all() \
                or not torch.isfinite(tree.c_value_upper).all() \
                or not (tree.d_mu_lcb <= tree.d_mu_ucb).all():
            raise AssertionError("MDP-GapE batch plan produced invalid actions, episodes or bounds")

        env, params, states = garnet_case(dev, branching=1)
        got = fields(*mdp_gape_plan_batch(env, params, states(dev, TREES), None, noise=noise,
                                          device=dev, **kw))
        want = fields(*mdp_gape_plan_batch(env, type(params)(*(v.cpu() for v in params)),
                                           states(cpu, CPU_SUBSET), None,
                                           noise=noise[:, :, :CPU_SUBSET], device=cpu, **kw))
        same_on_cpu("mdp_gape_plan_batch (deterministic garnet)", got, want,
                    ("best", "episodes_used", "d_parent", "d_count", "d_children", "c_children",
                     "c_child_keys", "d_used", "c_used"),
                    ("d_mu_ucb", "d_mu_lcb", "d_value_upper", "d_value_lower", "c_value_upper",
                     "c_value_lower"))
    return config_launches


def reset_sweeps():
    from rl_agents_torch.agents.tree_search.deterministic import _finalize_bounds
    from rl_agents_torch.agents.tree_search.graph_based import _value_iteration_sweeps as vi
    from rl_agents_torch.agents.tree_search.graph_based_stochastic import gbop_stochastic_plan

    vi.calls = vi.sweeps = vi.tree_sweeps = 0
    gbop_stochastic_plan.vi_calls = gbop_stochastic_plan.vi_sweeps = 0
    gbop_stochastic_plan.vi_tree_sweeps = 0
    _finalize_bounds.sweeps = 0


def sweep_line(trees: int) -> str:
    """The sweeps since ``reset_sweeps`` of the planners that made any: run
    (all trees together, until the last one stopped) and needed (the mean
    over ``trees`` trees of the sweeps each made before its own residual fell
    to the accuracy)."""
    from rl_agents_torch.agents.tree_search.deterministic import _finalize_bounds
    from rl_agents_torch.agents.tree_search.graph_based import _value_iteration_sweeps as vi
    from rl_agents_torch.agents.tree_search.graph_based_stochastic import gbop_stochastic_plan as g

    parts = []
    if vi.calls:
        parts.append(f"GBOP-D Bellman sweeps: {vi.sweeps} run in {vi.calls} calls, "
                     f"{vi.tree_sweeps / trees!r} needed per tree")
    if g.vi_calls:
        parts.append(f"stochastic GBOP value-iteration sweeps: {g.vi_sweeps} run in {g.vi_calls} "
                     f"calls, {g.vi_tree_sweeps / trees!r} needed per tree")
    if _finalize_bounds.sweeps:
        parts.append(f"OPD consolidation sweeps: {_finalize_bounds.sweeps}")
    return "; ".join(parts) or "no sweeps"


def graph_fields(graph, **extra) -> dict:
    from rl_agents_torch.convert import tree_to_numpy

    return dict(tree_to_numpy(graph)._asdict(), **{k: v.cpu().numpy() for k, v in extra.items()})


def check_gbop_batch_path(dev) -> dict:
    """``gbop_stochastic_plan_batch`` on Sailing at the sizes of ``gbop.json``:
    timed, its KL launches counted and their device time read from the
    profiler, its value-iteration sweeps counted, its first 64 trees held
    against the CPU plan under the same noise; then the planner with three
    next-state slots on 512 trees, one plan, with the Newton trips of its
    constrained expectations as run (in blocks).
    Returns the launches of the config's timed plans."""
    from rl_agents_torch.agents.tree_search.batch import gbop_stochastic_plan_batch
    from rl_agents_torch.utils import math as port_math
    from rl_agents_torch.utils.noise import gumbel, uniform

    env, params, states = sailing_case(dev)
    E, H, A = GBOP["episodes"], GBOP["horizon"], GBOP["num_actions"]
    states0 = states(dev, TREES)
    obs0 = env.observe(params, states0)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: gbop_stochastic_plan_batch(env, params, states0, obs0, generator, device=dev,
                                              **GBOP)
    # no warm-up plan: phase 3 ran this planner at these shapes already
    reset_launches()
    reset_sweeps()
    times = timed_plans(plan, SAILING_PLANS)
    launches = read_launches()
    expect_launches(f"stochastic GBOP batch path, {SAILING_PLANS} plans", launches, 0, 0,
                    SAILING_PLANS * GBOP_KL_LAUNCHES)
    report_plans(f"gbop_stochastic_plan_batch B={TREES} episodes={E} horizon={H} "
                 f"width={GBOP['width']}", times, TREES * E * H, "sample-steps")
    print(f"  {launches['kl_bounds_pair_'] // SAILING_PLANS} kl_bounds_pair_ launches per plan "
          f"(the dense form: {launches['kl_bound']}); "
          f"{SAILING_PLANS} plans: {sweep_line(TREES)}")
    # one episode of the three profiled: a whole plan's trace (~51k kernels)
    # lost half its records on an H100 (PERF.md §4)
    short = lambda: gbop_stochastic_plan_batch(env, params, states0, obs0, generator, device=dev,
                                               **dict(GBOP, episodes=1))
    profiled = profile_plan(short, host_events=False)
    if profiled["kl_launches"] != GBOP_KL_LAUNCHES // E:
        raise AssertionError(f"the profiler saw {profiled['kl_launches']} KL kernels in a "
                             f"one-episode plan, expected {GBOP_KL_LAUNCHES // E}")
    print(f"  the profiled plan ran 1 of {E} episodes")

    # the same noise on both devices: drawn once on the CPU
    cpu = torch.device("cpu")
    host = torch.Generator().manual_seed(7)
    noise = (gumbel((E, H, TREES, A), host, "cpu"), gumbel((TREES, A), host, "cpu"))
    env_noise = uniform((E, H, TREES), host, "cpu")
    action, graph = gbop_stochastic_plan_batch(env, params, states0, obs0, noise=noise,
                                               env_noise=env_noise, device=dev, **GBOP)
    if not ((action >= 0) & (action < A)).all() or not torch.isfinite(graph.value_upper).all() \
            or not (graph.value_lower <= graph.value_upper + KL_TOLERANCE).all() \
            or not (graph.n_count.sum(dim=1) == E * H).all() \
            or not (graph.sa_mu_lcb <= graph.sa_mu_ucb).all():
        raise AssertionError("stochastic GBOP batch plan produced invalid actions, counts or bounds")
    got = graph_fields(graph, action=action)
    states_cpu = states(cpu, CPU_SUBSET)
    params_cpu = env.default_params(cpu)
    action_cpu, graph_cpu = gbop_stochastic_plan_batch(
        env, params_cpu, states_cpu, env.observe(params_cpu, states_cpu),
        noise=(noise[0][:, :, :CPU_SUBSET], noise[1][:CPU_SUBSET]),
        env_noise=env_noise[:, :, :CPU_SUBSET], device=cpu, **GBOP)
    same_on_cpu("gbop_stochastic_plan_batch", got, graph_fields(graph_cpu, action=action_cpu),
                ("action", "visited", "n_count", "c_count", "sa_count", "sa_keys", "sa_child",
                 "sa_n", "used"),
                ("sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "value_lower", "value_upper"))

    print(f"-- three next-state slots, {GBOP_WIDE_TREES} trees")
    wide0 = states(dev, GBOP_WIDE_TREES)
    wide_obs = env.observe(params, wide0)
    wide = lambda: gbop_stochastic_plan_batch(env, params, wide0, wide_obs, generator, device=dev,
                                              **GBOP_WIDE)
    reset_launches()
    reset_newton()
    reset_sweeps()
    result = []
    ms = timed_plans(lambda: result.append(wide()), 1)[0]
    expect_launches("stochastic GBOP, three slots, 1 plan", read_launches(), 0, 0,
                    GBOP_KL_LAUNCHES)
    print(f"gbop_stochastic_plan_batch B={GBOP_WIDE_TREES} width=3: {ms!r} ms per plan, "
          f"{GBOP_WIDE_TREES * E * H / (ms / 1e3)!r} sample-steps/s; {newton_line()}, in blocks "
          f"of {port_math.NEWTON_BLOCK}; {sweep_line(GBOP_WIDE_TREES)}")
    # not profiled (tracing its ~650k kernels took two minutes of the budget)
    # and run once: the trips it needs were measured before (PERF.md section 5)
    action, graph = result[0]
    if not ((action >= 0) & (action < A)).all() or not torch.isfinite(graph.value_upper).all() \
            or int(graph.sa_n.max()) < 2:
        raise AssertionError("stochastic GBOP with three slots produced invalid actions, bounds "
                             "or never saw a second next state")
    return launches


def check_gbop_d_batch_path(dev) -> dict:
    """``gbop_plan_batch`` on Sailing at the sizes of ``gbop-d.json``; it
    launches no hand-written kernel (the JAX package computes GBOP-D outside
    any Pallas kernel too)."""
    from rl_agents_torch.agents.tree_search.batch import gbop_plan_batch
    from rl_agents_torch.utils.noise import gumbel

    env, params, states = sailing_case(dev)
    R, A = GBOP_D["expansions"], GBOP_D["num_actions"]
    arena = -((1 + R * A) // -8) * 8
    states0 = states(dev, TREES)
    obs0 = env.observe(params, states0)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: gbop_plan_batch(env, params, states0, obs0, generator, device=dev, **GBOP_D)
    plan()  # warm-up
    reset_launches()
    reset_sweeps()
    times = timed_plans(plan, SAILING_PLANS)
    launches = read_launches()
    expect_launches(f"GBOP-D batch path, {SAILING_PLANS} plans", launches, 0, 0)
    report_plans(f"gbop_plan_batch B={TREES} expansions={R} arena={arena}", times, TREES * R,
                 "expansions")
    print(f"  {SAILING_PLANS} plans: {sweep_line(TREES)}")
    profile_plan(plan, host_events=False)

    cpu = torch.device("cpu")
    host = torch.Generator().manual_seed(8)
    noise = [gumbel((TREES, arena, A), host, "cpu") for _ in range(R)]
    got = plan_fields(*gbop_plan_batch(env, params, states0, obs0, noise=noise, device=dev,
                                       **GBOP_D))
    if not ((got["lengths"] >= 1) & (got["lengths"] <= 64)).all() \
            or not np.isfinite(got["value_upper"]).all() \
            or not (got["value_lower"] <= got["value_upper"] + KL_TOLERANCE).all() \
            or not got["expanded"][:, 0].all():
        raise AssertionError("GBOP-D batch plan produced invalid lengths or bounds")
    states_cpu = states(cpu, CPU_SUBSET)
    params_cpu = env.default_params(cpu)
    want = plan_fields(*gbop_plan_batch(env, params_cpu, states_cpu,
                                        env.observe(params_cpu, states_cpu),
                                        noise=[g[:CPU_SUBSET] for g in noise], device=cpu,
                                        **GBOP_D))
    same_on_cpu("gbop_plan_batch", got, want,
                ("actions", "lengths", "keys", "expanded", "children", "used"),
                ("rewards", "value_lower", "value_upper"))
    return launches


def check_opd_batch_path(dev) -> dict:
    """``opd_plan_batch`` on the CartPole starts of the other paths at the JAX
    bench's budget; it launches no hand-written kernel (the JAX package
    computes OPD outside any Pallas kernel too)."""
    from rl_agents_torch.agents.tree_search.batch import opd_plan_batch
    from rl_agents_torch.utils.noise import gumbel

    env, params, states = cartpole_case(dev)
    R, A, P = OPD["expansions"], OPD["num_actions"], 32
    states0 = states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: opd_plan_batch(env, params, states0, generator, device=dev, **OPD)
    plan()  # warm-up
    reset_launches()
    reset_sweeps()
    times = timed_plans(plan)
    launches = read_launches()
    expect_launches(f"OPD batch path, {PLANS} plans", launches, 0, 0)
    report_plans(f"opd_plan_batch B={TREES} expansions={R}", times, TREES * R, "expansions")
    print(f"  {PLANS} plans: {sweep_line(TREES)}")
    profile_plan(plan)

    cpu = torch.device("cpu")
    noise = gumbel((P, A, TREES), torch.Generator().manual_seed(9), "cpu")
    got = plan_fields(*opd_plan_batch(env, params, states0, None, noise=noise, device=dev, **OPD))
    if not ((got["lengths"] >= 1) & (got["lengths"] <= P)).all() \
            or not (got["count"][:, 0] == 1 + R * A).all() \
            or not np.isfinite(got["value_upper"]).all() \
            or not (got["value_lower"] <= got["value_upper"]).all():
        raise AssertionError("OPD batch plan produced invalid lengths, counts or bounds")
    want = plan_fields(*opd_plan_batch(env, env.default_params(cpu), states(cpu, CPU_SUBSET), None,
                                       noise=noise[..., :CPU_SUBSET], device=cpu, **OPD))
    same_on_cpu("opd_plan_batch", got, want,
                ("actions", "lengths", "parent", "depth", "children", "done", "leaf", "count"),
                ("reward", "value_lower", "value_upper"))
    return launches


def check_agent_path(dev, name: str, env_config, agent_config, kl_bound_per_plan: int,
                     kl_bound_indexed_per_plan: int, check=None,
                     kl_bounds_pair_per_plan: int = 0) -> dict:
    """One episode through ``load_environment`` / ``load_agent`` /
    ``Evaluation.test`` on the card; returns the launches of each KL wrapper,
    which must be the given numbers per planning step. ``check(env, agent)``
    runs before the episode."""
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.trainer.evaluation import Evaluation

    env = load_environment(env_config, device=dev)
    agent = load_agent(agent_config, env, device=dev)
    if check is not None:
        check(env, agent)
    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke", num_episodes=1,
                            training=False, sim_seed=0)
    reset_launches()
    reset_newton()
    reset_sweeps()
    started = time.time()
    evaluation.test()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = read_launches()
    episodes_file = evaluation.run_directory / Evaluation.EPISODES_FILE
    episode = json.loads(episodes_file.read_text().splitlines()[-1])
    planner = getattr(agent, "sub_agent", agent)  # IRP plans with its sub-agent
    sizes = (f"{planner.config['episodes']} episodes x horizon {planner.config['horizon']}"
             if "episodes" in planner.config
             else f"{planner.config['budget'] // env.action_space.n} expansions")
    print(f"{name} agent path: budget {planner.config['budget']} ({sizes}), "
          f"return {episode['total_reward']!r} in {episode['length']} steps, {seconds!r} s "
          f"({seconds / episode['length']!r} s per step), launches {launches}; {newton_line()}; "
          f"{sweep_line(1)}")
    if not np.isfinite(episode["total_reward"]) or episode["length"] < 1:
        raise AssertionError(f"{name} agent path: invalid episode {episode}")
    expect_launches(f"{name} agent path", launches, kl_bound_per_plan * episode["length"],
                    kl_bound_indexed_per_plan * episode["length"],
                    kl_bounds_pair_per_plan * episode["length"])
    return launches


# ---------------------------------------------------------------------------
# The highway family: the JAX bench's highway lines and the robust planners
# ---------------------------------------------------------------------------

def highway_case(dev, config_path=CONFIGS / "HighwayEnv" / "env.json"):
    """The env of a corpus highway config on ``dev`` and ``TREES`` start
    states drawn once by the port's ``reset`` from a seeded CPU generator, so
    that both devices plan from the same states."""
    from rl_agents_torch.envs import highway
    from rl_agents_torch.factory import ENV_REGISTRY

    config = json.loads(Path(config_path).read_text())
    make = getattr(highway, ENV_REGISTRY[config["id"]].split(":")[1])
    env = make(dict(config), device="cpu").functional
    start, _ = env.reset(env.default_params("cpu"), torch.Generator().manual_seed(5), TREES)

    base = make(dict(config), device="cpu").params

    def states(device, n):
        return type(start)(*(x[:n].to(device) for x in start))

    def params(device):
        return type(base)(*(v.to(device) for v in base))

    return env, params, states


def drop_case(dev):
    """``merge-v0`` (``MergeEnv/env.json``) with the two models of
    ``MergeEnv/agents/DiscreteRobustPlannerAgent.json``, the Aggressive and the
    Defensive presets, stacked on a leading model axis; the start states
    ``[n, M, ...]``."""
    from rl_agents_torch.agents.robust.robust import stack_params
    from rl_agents_torch.factory import load_environment, preprocess_env

    agent = json.loads((CONFIGS / "MergeEnv" / "agents" / "DiscreteRobustPlannerAgent.json")
                       .read_text())
    env, _, states = highway_case(dev, CONFIGS / "MergeEnv" / "env.json")
    handle = load_environment(CONFIGS / "MergeEnv" / "env.json", device="cpu")
    ensemble = stack_params([preprocess_env(handle, [model]).params for model in agent["models"]])
    M = ensemble[0].shape[0]

    def model_states(device, n):
        return type(states(CPU, 1))(*(x[:, None].expand((n, M) + x.shape[1:]).contiguous()
                                      for x in states(device, n)))

    def params(device):
        return type(ensemble)(*(v.to(device) for v in ensemble))

    return env, params, model_states, M


def highway_batch_path(dev, name: str, run, make_noise, cut, fields, exact, close, work: int,
                       unit: str, kl_bounds_pair: int = 0, kl_bound_indexed: int = 0,
                       trees: int | None = None, validate=None, short=None) -> dict:
    """One highway batch path: ``run(device, n, noise)`` plans the first
    ``n`` trees (noise None: drawn from a generator on the device).
    ``HW_PLANS`` timed plans with the launches of each KL form counted (the given
    numbers per plan; no warm-up plan: phase 3 and the earlier paths warmed
    the kernels, and the median takes the rest), then one profiled plan under
    noise drawn on the CPU, whose first ``CPU_SUBSET`` trees are held against
    the CPU plan of the same trees. ``short``, ``(episodes, run_short(device,
    n), KL launches)``, profiles a plan of fewer episodes instead, since
    reading a trace takes time in proportion to its kernels; the plan under
    noise then runs unprofiled."""
    trees = trees or TREES
    subset = CPU_SUBSET
    plan = lambda: run(dev, trees, None)
    reset_launches()
    reset_sweeps()
    times = timed_plans(plan, HW_PLANS)
    launches = read_launches()
    expect_launches(f"{name}, {HW_PLANS} plans", launches, 0, HW_PLANS * kl_bound_indexed,
                    HW_PLANS * kl_bounds_pair)
    ms = report_plans(f"{name} B={trees}", times, work, unit)
    print(f"  {launches} launches in {HW_PLANS} plans; {sweep_line(trees)}")
    noise = make_noise(trees)
    results = []
    if short is None:
        profiled = profile_plan(lambda: results.append(run(dev, trees, noise)), host_events=False)
        kl_expected = kl_bounds_pair + kl_bound_indexed
    else:
        episodes, run_short, kl_expected = short
        profiled = profile_plan(lambda: run_short(dev, trees), host_events=False)
        profiled["profiled_episodes"] = episodes
        print(f"  the profiled plan ran {episodes} episodes: "
              f"{profiled['kernels'] / episodes!r} device kernels an episode")
        results.append(run(dev, trees, noise))
    if profiled["kl_launches"] != kl_expected:
        raise AssertionError(f"{name}: the profiler saw {profiled['kl_launches']} KL kernels in "
                             f"the profiled plan, expected {kl_expected}")
    got = fields(results[0])
    if validate is not None:
        validate(got)
    started = time.time()
    want = fields(run(CPU, subset, cut(noise, subset)))
    print(f"  CPU plan of {subset} trees: {time.time() - started!r} s")
    same_on_cpu(name, got, want, exact, close, subset)
    return {"launches": launches, "ms": ms, "kernels": profiled["kernels"],
            "busy_share": profiled["busy_share"],
            **({"profiled_episodes": short[0]} if short else {})}


def expect(condition: bool, message: str):
    if not condition:
        raise AssertionError(message)


def check_highway_batch_paths(dev) -> dict:
    """The six highway batch paths at the JAX bench's sizes
    (``bench.py:242-367``), KL-OLOP at ``kl-olop.json``'s and DROP at
    ``DiscreteRobustPlannerAgent.json``'s, all at the full width of
    ``HighwayEnv/env.json`` (15 vehicles, 4 lanes, 40 steps). Returns, per
    path, its launches and measurements."""
    from rl_agents_torch.agents.tree_search import batch
    from rl_agents_torch.agents.tree_search.mcts import gumbel

    env, params, states = highway_case(dev)
    A = HW_ACTIONS
    probs = torch.ones(A) / A
    out = {}

    def gen(device, noise):
        return torch.Generator(device=device).manual_seed(0) if noise is None else None

    def host(seed):
        return torch.Generator().manual_seed(seed)

    print("-- MCTS")
    out["highway_mcts"] = highway_batch_path(
        dev, "mcts_plan_batch on highway",
        lambda d, n, noise: batch.mcts_plan_batch(env, params(d), states(d, n), gen(d, noise),
                                                  probs, probs, noise=noise, device=d, **HW_MCTS),
        lambda n: gumbel((EPISODES, HORIZON, 2, A, n), host(21), "cpu"),
        lambda noise, n: noise[..., :n], lambda r: plan_fields(*r),
        ("actions", "lengths", "count", "parent"), ("value",), TREES * EPISODES * HORIZON,
        "env-steps",
        validate=lambda g: expect((g["count"][:, 0] == EPISODES).all()
                                  and np.isfinite(g["value"]).all(), "MCTS on highway: counts"),
        short=(HW_PROFILED_EPISODES, lambda d, n: batch.mcts_plan_batch(
            env, params(d), states(d, n), gen(d, None), probs, probs, device=d,
            **dict(HW_MCTS, episodes=HW_PROFILED_EPISODES)), 0))

    print("-- OPD")
    P = HW_OPD["plan_capacity"]
    out["highway_opd"] = highway_batch_path(
        dev, "opd_plan_batch on highway",
        lambda d, n, noise: batch.opd_plan_batch(env, params(d), states(d, n), gen(d, noise),
                                                 noise=noise, device=d, **HW_OPD),
        lambda n: gumbel((P, A, n), host(22), "cpu"), lambda noise, n: noise[..., :n],
        lambda r: plan_fields(*r),
        ("actions", "lengths", "parent", "depth", "children", "done", "leaf", "count"),
        ("reward", "value_lower", "value_upper"), TREES * HW_OPD["expansions"], "expansions",
        validate=lambda g: expect((g["count"][:, 0] == 1 + HW_OPD["expansions"] * A).all()
                                  and (g["value_lower"] <= g["value_upper"]).all(),
                                  "OPD on highway: counts or bounds"))

    print("-- GBOP-D")
    R = HW_GBOP_D["expansions"]
    arena = -((1 + R * A) // -8) * 8

    def gbop_d(d, n, noise):
        s = states(d, n)
        return batch.gbop_plan_batch(env, params(d), s, env.observe(params(d), s), gen(d, noise),
                                     noise=noise, device=d, **HW_GBOP_D)

    out["highway_gbop_d"] = highway_batch_path(
        dev, "gbop_plan_batch on highway", gbop_d,
        lambda n: [gumbel((n, arena, A), host(23 + r), "cpu") for r in range(R)],
        lambda noise, n: [g[:n] for g in noise], lambda r: plan_fields(*r),
        ("actions", "lengths", "keys", "expanded", "children", "used"),
        ("rewards", "value_lower", "value_upper"), TREES * R, "expansions",
        validate=lambda g: expect((g["used"] > 1 + A).all(),
                                  "GBOP-D on highway: no observation reached a known node"))

    print("-- stochastic GBOP")
    E, H = HW_GBOP["episodes"], HW_GBOP["horizon"]

    def gbop(d, n, noise):
        s = states(d, n)
        action, graph = batch.gbop_stochastic_plan_batch(
            env, params(d), s, env.observe(params(d), s), gen(d, noise), noise=noise, device=d,
            **HW_GBOP)
        return graph_fields(graph, action=action)

    out["highway_gbop_stochastic"] = highway_batch_path(
        dev, "gbop_stochastic_plan_batch on highway", gbop,
        lambda n: (gumbel((E, H, n, A), host(40), "cpu"), gumbel((n, A), host(41), "cpu")),
        lambda noise, n: (noise[0][:, :, :n], noise[1][:n]), lambda r: r,
        ("action", "visited", "n_count", "c_count", "sa_count", "sa_keys", "sa_child", "sa_n",
         "used"),
        ("sa_cum_reward", "sa_mu_ucb", "sa_mu_lcb", "value_lower", "value_upper"),
        HW_GBOP_TREES * E * H, "sample-steps", kl_bounds_pair=HW_GBOP_KL_LAUNCHES,
        trees=HW_GBOP_TREES,
        validate=lambda g: expect((g["n_count"].sum(axis=1) == E * H).all()
                                  and (g["sa_mu_lcb"] <= g["sa_mu_ucb"]).all(),
                                  "stochastic GBOP on highway: counts or bounds"))

    print("-- KL-OLOP")
    E, H = HW_OLOP["episodes"], HW_OLOP["horizon"]

    def olop(d, n, noise):
        return plan_fields(*batch.olop_plan_batch(env, params(d), states(d, n), gen(d, noise),
                                                  random_actions=noise, device=d, **HW_OLOP))

    out["highway_kl_olop"] = highway_batch_path(
        dev, "olop_plan_batch on highway (kl-olop.json)", olop,
        lambda n: torch.randint(0, A, (E, H, n), generator=host(42)),
        lambda noise, n: noise[..., :n], lambda r: r,
        ("actions", "lengths", "parent", "children", "depth", "count", "done", "used"),
        ("mu_ucb", "value_upper"), TREES * E * H, "env-steps", kl_bound_indexed=E,
        validate=lambda g: expect(
            (np.take_along_axis(g["count"], g["children"][:, 0], 1).sum(axis=1) == E).all(),
            "KL-OLOP on highway: the root's children were not visited once per episode"),
        short=(HW_OLOP_PROFILED_EPISODES, lambda d, n: batch.olop_plan_batch(
            env, params(d), states(d, n), gen(d, None), device=d,
            **dict(HW_OLOP, episodes=HW_OLOP_PROFILED_EPISODES)), HW_OLOP_PROFILED_EPISODES))

    print("-- DROP on merge-v0")
    denv, dparams, dstates, M = drop_case(dev)
    P = min(HW_DROP["expansions"], 64)

    def drop(d, n, noise):
        return plan_fields(*batch.robust_opd_plan_batch(
            denv, dparams(d), dstates(d, n), gen(d, noise), num_models=M, plan_capacity=P,
            noise=noise, device=d, **HW_DROP))

    out["highway_drop"] = highway_batch_path(
        dev, f"robust_opd_plan_batch on merge-v0, {M} models", drop,
        lambda n: gumbel((P, n, A), host(43), "cpu"), lambda noise, n: noise[:, :n], lambda r: r,
        ("actions", "lengths", "parent", "action", "depth", "children", "done", "leaf", "used"),
        ("reward", "value_lower", "value_upper"), TREES * M * HW_DROP["expansions"],
        "model-expansions",
        validate=lambda g: expect((g["value_lower"] <= g["value_upper"]).all()
                                  and (g["lengths"] >= 1).all(), "DROP on merge: bounds"))
    return out


def check_highway_agent_paths(dev) -> dict:
    """Five agent paths, 3 steps each, through ``load_environment`` /
    ``load_agent`` / ``Evaluation.test``."""
    from rl_agents_torch.factory import preprocess_env

    highway = json.loads((CONFIGS / "HighwayEnv" / "env.json").read_text())
    highway["max_episode_steps"] = HIGHWAY_AGENT_STEPS
    merge = json.loads((CONFIGS / "MergeEnv" / "env.json").read_text())
    merge["max_episode_steps"] = HIGHWAY_AGENT_STEPS
    agents = CONFIGS / "HighwayEnv" / "agents"
    paths = {}
    paths["highway_opd_agent"] = check_agent_path(
        dev, "DeterministicPlannerAgent on highway", highway,
        agents / "DeterministicPlannerAgent.json", 0, 0)
    paths["highway_mcts_agent"] = check_agent_path(dev, "MCTSAgent on highway", highway,
                                                   agents / "MCTSAgent.json", 0, 0)

    def simplified(env, agent):
        smaller = preprocess_env(env, agent.config["env_preprocessors"])
        expect(smaller.functional.vehicles == 6 and smaller.state.x.shape == (1, 6),
               "kl-olop.json's simplify did not keep 6 vehicles")
        print(f"  kl-olop.json plans on {smaller.functional.vehicles} of "
              f"{env.functional.vehicles} vehicles, {agent.config['episodes']} episodes x "
              f"horizon {agent.config['horizon']}: {agent.config['episodes']} "
              f"kl_bound_indexed_ launches per act()")

    paths["highway_kl_olop_agent"] = check_agent_path(
        dev, "OLOPAgent (kl-olop.json) on highway", highway, agents / "OLOPAgent" / "kl-olop.json",
        0, HW_OLOP["episodes"], check=simplified)
    paths["highway_irp_agent"] = check_agent_path(
        dev, "IntervalRobustPlannerAgent on highway", highway,
        agents / "IntervalRobustPlannerAgent" / "baseline.json", 0, 0)
    paths["merge_drop_agent"] = check_agent_path(
        dev, "DiscreteRobustPlannerAgent on merge-v0", merge,
        CONFIGS / "MergeEnv" / "agents" / "DiscreteRobustPlannerAgent.json", 0, 0)
    return paths


# ---------------------------------------------------------------------------
# The DQN learner: the model zoo, the agent through the harness, the fused
# actor-learner
# ---------------------------------------------------------------------------

def tf32_line() -> str:
    return (f"TF32: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32} (the zoo's convolutions run with it off)")


def entity_batch(batch: int, seed: int) -> torch.Tensor:
    """Kinematics-like observations on the CPU: column 0 is presence, about
    30% of the others absent, the ego present."""
    generator = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 15, 7), generator=generator)
    x[:, :, 0] = (torch.rand((batch, 15), generator=generator) > 0.3).float()
    x[:, 0, 0] = 1.0
    return x


def check_models(dev) -> dict:
    """The EgoAttentionNetwork at entry()'s widths on the card against the
    same weights on the CPU, at batch 8 and at the serving batch, with its
    attention matrix; forwards per second by CUDA events, float32 and
    bfloat16."""
    import copy

    from rl_agents_torch.models.zoo import EgoAttentionNetwork, init_parameters

    print(tf32_line())
    cpu_model = init_parameters(EgoAttentionNetwork(7, **EGO_MODEL),
                                torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).to(dev)
    bf16 = EgoAttentionNetwork(7, dtype=torch.bfloat16, **EGO_MODEL).to(dev)
    bf16.load_state_dict(model.state_dict())
    rates = {}
    for batch in (ENTRY_BATCH, SERVING_BATCH):
        x = entity_batch(batch, seed=batch)
        xd = x.to(dev)
        with torch.no_grad():
            want, got = cpu_model(x), model(xd).cpu()
            att_err = float((cpu_model.get_attention_matrix(x)
                             - model.get_attention_matrix(xd).cpu()).abs().max())
            err = float((got - want).abs().max())
            bf16_err = float((bf16(xd).float().cpu() - want).abs().max())
            expect(got.shape == (batch, 5) and bool(torch.isfinite(got).all()),
                   "EgoAttentionNetwork on the card: bad output")
            expect(err <= MODEL_TOLERANCE and att_err <= MODEL_TOLERANCE,
                   f"EgoAttentionNetwork at batch {batch}: card against CPU {err!r}, "
                   f"attention {att_err!r}, above {MODEL_TOLERANCE}")
            expect(bf16_err <= 2e-2 * float(want.abs().max()),
                   f"bfloat16 EgoAttentionNetwork at batch {batch}: {bf16_err!r} from float32")
            reps = 200 if batch == ENTRY_BATCH else 50
            ms = cuda_ms(lambda: model(xd), reps)
            bf16_ms = cuda_ms(lambda: bf16(xd), reps)
        rates[batch] = batch / (ms / 1e3)
        print(f"EgoAttentionNetwork batch {batch} x 15 x 7: max |card - CPU| {err!r} "
              f"(attention {att_err!r}); float32 {ms!r} ms a forward, {rates[batch]!r} "
              f"samples/s; bfloat16 {bf16_ms!r} ms, {batch / (bf16_ms / 1e3)!r} samples/s, "
              f"max |bf16 - f32| {bf16_err!r}")
    return {"launches": read_launches(), "serving_samples_per_s": rates[SERVING_BATCH]}


def check_dqn_object_path(dev) -> dict:
    """``ego_attention.json`` on ``HighwayEnv/env.json`` (15 vehicles, 4
    lanes): ``load_environment``, ``load_agent`` and
    ``Evaluation(training=True).train()`` for two episodes on the card, one
    SGD step per ``record`` once the memory holds a batch; then one train
    step's gradients on the card against the CPU on the same batch and
    weights, the timing of a train step, and a greedy ``test()`` episode of
    10 steps of an agent recovered from ``saved_models/latest.tar``."""
    from rl_agents_torch.agents.dqn.agent import loss_and_gradients
    from rl_agents_torch.agents.dqn.replay import Batch
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.trainer.evaluation import Evaluation

    directory = REPO / "out" / "chip_smoke" / "dqn"
    env = load_environment(CONFIGS / "HighwayEnv" / "env.json", device=dev)
    agent = load_agent(DQN_AGENT, env, device=dev)
    expect(env.functional.vehicles == 15 and type(agent.model).__name__ == "EgoAttentionNetwork",
           "the DQN object path is not the uncut highway EgoAttention agent")
    evaluation = Evaluation(env, agent, directory=directory, num_episodes=DQN_EPISODES,
                            training=True, sim_seed=0)
    reset_launches()
    started = time.time()
    evaluation.train()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = read_launches()
    episodes = [json.loads(line) for line in
                (evaluation.run_directory / Evaluation.EPISODES_FILE).read_text().splitlines()]
    env_steps = sum(e["length"] for e in episodes)
    expected = env_steps - agent.config["batch_size"] + 1
    expect(agent.steps == expected > 0, f"DQN object path: {agent.steps} SGD steps, expected "
                                        f"{expected} for {env_steps} recorded transitions")
    for name in ("checkpoint-0.tar", "checkpoint-1.tar", "checkpoint-final.tar"):
        expect((evaluation.run_directory / name).is_file(), f"DQN object path: no {name}")
    print(f"DQNAgent (ego_attention.json) on highway, {DQN_EPISODES} training episodes: "
          f"{env_steps} env steps, {agent.steps} SGD steps, returns "
          f"{[e['total_reward'] for e in episodes]}, {seconds!r} s "
          f"({seconds / env_steps * 1e3!r} ms per env step with its SGD step), launches "
          f"{launches}")
    train_ms = seconds / env_steps * 1e3

    batch = agent.memory.sample(agent.config["batch_size"])
    state = agent.train_state
    grads = []
    for device in (dev, CPU):  # the model is evaluated on the parameters it is given
        params = {k: v.to(device) for k, v in state.params.items()}
        target = {k: v.to(device) for k, v in state.target_params.items()}
        grads.append(loss_and_gradients(
            agent.model, agent.loss_function, params, target,
            Batch(*(x.to(device) for x in batch)), agent.config["gamma"], agent.config["double"]))
    (loss_d, grads_d), (loss_c, grads_c) = grads
    worst = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for g, c in zip(grads_d, grads_c))
    expect(worst <= MODEL_TOLERANCE, f"DQN gradients: card against CPU {worst!r} of the leaf's "
                                     f"largest entry, above {MODEL_TOLERANCE}")
    sgd_ms = cuda_ms(lambda: agent.train_step(state, batch), 50)
    print(f"  one train step on the card against the CPU: loss {float(loss_d)!r} / "
          f"{float(loss_c)!r}, gradients within {worst!r} of each leaf's largest entry; "
          f"{sgd_ms!r} ms per SGD step (batch {agent.config['batch_size']})")

    test_env_config = json.loads((CONFIGS / "HighwayEnv" / "env.json").read_text())
    test_env_config["max_episode_steps"] = DQN_TEST_STEPS
    test_env = load_environment(test_env_config, device=dev)
    recovered = load_agent(DQN_AGENT, test_env, device=dev)
    test = Evaluation(test_env, recovered, directory=directory, num_episodes=1, sim_seed=0,
                      recover=True)
    for key, value in agent.train_state.params.items():
        expect(torch.equal(recovered.train_state.params[key], value),
               f"latest.tar did not restore {key}")
    reset_launches()
    started = time.time()
    test.test()
    torch.cuda.synchronize()
    seconds = time.time() - started
    episode = json.loads((test.run_directory / Evaluation.EPISODES_FILE).read_text()
                         .splitlines()[-1])
    expect(1 <= episode["length"] <= DQN_TEST_STEPS and np.isfinite(episode["total_reward"]),
           f"greedy test episode: {episode}")
    print(f"  greedy test() of the recovered agent: return {episode['total_reward']!r} in "
          f"{episode['length']} steps, {seconds / episode['length'] * 1e3!r} ms per step")
    launches = {k: v + read_launches()[k] for k, v in launches.items()}
    return {"launches": launches, "sgd_ms": sgd_ms, "env_step_ms": train_ms, "agent": agent,
            "handle": env}


def greedy_returns(env, model, params, episodes: int, dev, seed: int = 123,
                   max_steps: int = 200) -> torch.Tensor:
    """Total reward of the greedy policy over ``episodes`` CartPole episodes
    run side by side on the card (tests/test_dqn_curve_parity.py::greedy_eval)."""
    from rl_agents_torch.agents.dqn.agent import q_values

    env_params = env.default_params(dev)
    states, obs = env.reset(env_params, torch.Generator(device=dev).manual_seed(seed), episodes)
    done = torch.zeros(episodes, dtype=torch.bool, device=dev)
    total = torch.zeros(episodes, device=dev)
    with torch.no_grad():
        for _ in range(max_steps):
            actions = q_values(model, params, obs.float()).argmax(dim=1)
            out = env.step(env_params, states, actions)
            total += torch.where(done, 0.0, out.reward)
            done = done | out.terminated | out.truncated
            states, obs = out.state, out.obs
    return total


def check_graph_against_eager(env, dev):
    """The captured step replayed against the eager step: one seed, so one
    initial state and one sequence of draws, two segments of
    ``GRAPH_CHECK_STEPS`` steps each way (training from the fifth step); the
    ring and the counters equal, the parameters within ``MODEL_TOLERANCE``.
    The second segment, with no capture in it, is timed."""
    from rl_agents_torch.models.optimizers import optimizer_factory
    from rl_agents_torch.models.zoo import MultiLayerPerceptron
    from rl_agents_torch.parallel.actor_learner import make_actor_learner

    kw = dict(CURVE, learning_starts=4 * CURVE["num_envs"], device=dev)
    for key in ("total_steps", "segment", "seed"):
        kw.pop(key)
    runs = []
    for graph in (False, True):
        model = MultiLayerPerceptron(4, CURVE_LAYERS, out=2)
        init_fn, segment_fn = make_actor_learner(env, model, optimizer_factory("ADAM"),
                                                 cuda_graph=graph, **kw)
        state = init_fn(torch.Generator(device=dev).manual_seed(1))
        segment_fn(state, steps=GRAPH_CHECK_STEPS)  # with the graph: captured here
        torch.cuda.synchronize()
        started = time.time()
        segment_fn(state, steps=GRAPH_CHECK_STEPS)
        torch.cuda.synchronize()
        runs.append((state, (time.time() - started) / GRAPH_CHECK_STEPS * 1e3))
    (eager, eager_ms), (graph, graph_ms) = runs
    for field in ("action", "reward", "terminal", "state"):
        expect(torch.equal(getattr(eager.buffer, field), getattr(graph.buffer, field)),
               f"CUDA graph against eager: the ring's {field} differs")
    for field in ("position", "size", "time", "completed_count"):
        expect(int(getattr(eager, field)) == int(getattr(graph, field)),
               f"CUDA graph against eager: {field} differs")
    worst = max(float((eager.params[k] - graph.params[k]).abs().max()) for k in eager.params)
    expect(worst <= MODEL_TOLERANCE and int(graph.opt_state["count"]) > 0,
           f"CUDA graph against eager: parameters {worst!r} apart")
    print(f"fused CartPole step, 2 x {GRAPH_CHECK_STEPS} steps from one seed: "
          f"eager {eager_ms!r} ms a step, CUDA graph {graph_ms!r} ms a step; ring and counters "
          f"equal, parameters within {worst!r}")


def check_fused_learner(dev) -> dict:
    """(a) The CartPole learning curve at tests/test_dqn_curve_parity.py's
    settings, one step captured in a CUDA graph and replayed; the greedy mean
    over 64 episodes must reach the reference band's lower edge. (b) The
    EgoAttention learner at bench_dqn_ego_attention's sizes: a warm segment,
    a timed one, and a profiled short one."""
    from rl_agents_torch.envs.cartpole import CartPoleEnv
    from rl_agents_torch.factory import load_environment
    from rl_agents_torch.models.optimizers import optimizer_factory
    from rl_agents_torch.models.zoo import EgoAttentionNetwork, MultiLayerPerceptron
    from rl_agents_torch.parallel.actor_learner import make_actor_learner, train_dqn_fused

    band = json.loads((REPO / "tests" / "data" / "dqn_cartpole_reference_curve.json").read_text())
    lower_edge = band["final_window_mean"] - 2 * band["final_window_std"]
    env = CartPoleEnv(max_episode_steps=200)
    check_graph_against_eager(env, dev)
    model = MultiLayerPerceptron(4, CURVE_LAYERS, out=2)
    reset_launches()
    torch.cuda.synchronize()
    started = time.time()
    state, history = train_dqn_fused(env, model, device=dev, **CURVE)
    torch.cuda.synchronize()
    seconds = time.time() - started
    returns = greedy_returns(env, model, state.params, CURVE_EPISODES, dev)
    mean = float(returns.mean())
    steps, curve_seconds = CURVE["total_steps"], seconds
    print(f"(a) fused DQN on CartPole, {steps} steps x {CURVE['num_envs']} envs in a CUDA graph: "
          f"{seconds!r} s, {steps * CURVE['num_envs'] / seconds!r} env-steps/s, "
          f"{seconds / steps * 1e3!r} ms per step; EMA of completed returns "
          f"{[round(h, 1) for h in history]}; greedy mean over {CURVE_EPISODES} episodes "
          f"{mean!r} (bar {lower_edge!r})")
    expect(int(state.time) == steps and int(state.opt_state["count"]) > 0,
           "fused CartPole learner: the steps or updates did not run")
    expect(mean >= lower_edge, f"fused DQN greedy mean {mean!r} below the reference band's "
                               f"lower edge {lower_edge!r}")
    launches = read_launches()

    handle = load_environment(CONFIGS / "HighwayEnv" / "env.json", device=dev)
    functional = handle.functional
    ego = EgoAttentionNetwork(functional.observation_space.shape[-1], **EGO_MODEL)
    init_fn, segment_fn = make_actor_learner(functional, ego, optimizer_factory("ADAM"),
                                             device=dev, **EGO_FUSED)
    state = init_fn(torch.Generator(device=dev).manual_seed(0), env_params=handle.params)
    reset_launches()
    segment_fn(state, steps=EGO_FUSED_WARM)
    torch.cuda.synchronize()
    started = time.time()
    _, reward = segment_fn(state, steps=EGO_FUSED_STEPS)
    torch.cuda.synchronize()
    seconds = time.time() - started
    rate = EGO_FUSED_STEPS * EGO_FUSED["num_envs"] / seconds
    expect(bool(torch.isfinite(reward)) and int(state.opt_state["count"]) > 0
           and all(bool(torch.isfinite(p).all()) for p in state.params.values()),
           "fused EgoAttention learner: no update or non-finite parameters")
    print(f"(b) fused DQN, EgoAttentionNetwork on highway (15 vehicles, 4 lanes), "
          f"{EGO_FUSED['num_envs']} envs, batch {EGO_FUSED['batch_size']}, capacity "
          f"{EGO_FUSED['capacity']}: {EGO_FUSED_STEPS} steps in {seconds!r} s, "
          f"{seconds / EGO_FUSED_STEPS * 1e3!r} ms per step, {rate!r} env-steps/s, "
          f"{int(state.completed_count)} episodes ended, EMA return "
          f"{float(state.completed_return)!r}")
    profiled = profile_plan(lambda: segment_fn(state, steps=EGO_FUSED_PROFILED), host_events=False)
    print(f"  profiled {EGO_FUSED_PROFILED} steps: {profiled['kernels'] / EGO_FUSED_PROFILED!r} "
          f"device kernels per step")
    launches = {k: v + read_launches()[k] for k, v in launches.items()}
    return {"launches": launches, "curve_mean": mean, "curve_seconds": curve_seconds,
            "ego_env_steps_per_s": rate, "ego_busy_share": profiled["busy_share"]}


# ---------------------------------------------------------------------------
# Slice 7: dynamic programming, MCTS with a prior, FTQ and BFTQ
# ---------------------------------------------------------------------------

def timed_agent_episode(dev, name: str, env, agent, steps_note: str = "") -> dict:
    """One test episode of ``agent`` through ``Evaluation.test()`` with the
    KL counters zeroed before and read after (no KL launch is expected);
    returns the episode, its seconds per ``act()`` and the launches."""
    from rl_agents_torch.trainer.evaluation import Evaluation

    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke", num_episodes=1,
                            training=False, sim_seed=0)
    reset_launches()
    started = time.time()
    evaluation.test()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = read_launches()
    episode = json.loads((evaluation.run_directory / Evaluation.EPISODES_FILE).read_text()
                         .splitlines()[-1])
    expect(np.isfinite(episode["total_reward"]) and episode["length"] >= 1,
           f"{name}: invalid episode {episode}")
    expect_launches(name, launches, 0, 0)
    per_act = seconds / episode["length"]
    print(f"{name}: return {episode['total_reward']!r} in {episode['length']} steps, "
          f"{per_act!r} s per act(){steps_note}, launches {launches}")
    return {"launches": launches, "s_per_act": per_act}


def same_q_table(name: str, got, want, exact: bool):
    """A Q table computed on the card against the CPU's: equal in the
    deterministic and sparse encodings, within DP_STOCHASTIC_REL of the
    largest entry in the stochastic one."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    if exact:
        expect(np.array_equal(got, want), f"{name}: the card's Q table differs from the CPU's "
                                          f"by {err!r}")
    else:
        expect(err <= DP_STOCHASTIC_REL * float(np.abs(want).max()),
               f"{name}: the card's Q table differs from the CPU's by {err!r}")
    print(f"  {name}: Q table {got.shape} on the card {'equal to' if exact else 'within'} "
          f"the CPU's (max|diff| {err!r})")


def check_dynamic_programming(dev) -> dict:
    """Value Iteration on the uncut highway TTC view and on Sailing, Robust
    and plain Value Iteration on FiniteMDPEnv/large, and the stochastic
    contraction on a random MDP: each Q table on the card against the CPU's,
    the updates to convergence, and seconds per act()."""
    from rl_agents_torch.agents.dynamic_programming import bellman
    from rl_agents_torch.factory import load_agent, load_environment

    paths = {}
    highway = json.loads((CONFIGS / "HighwayEnv" / "env.json").read_text())
    highway["max_episode_steps"] = DP_AGENT_STEPS
    vi_config = CONFIGS / "HighwayEnv" / "agents" / "ValueIterationAgent" / "baseline.json"
    env = load_environment(highway, device=dev)
    agent = load_agent(vi_config, env, device=dev)
    expect(env.functional.vehicles == 15 and agent.rederive_each_act,
           "ValueIterationAgent on highway: not the uncut env's TTC view")
    cpu_env = load_environment(highway, device="cpu")
    cpu_env.state = type(env.state)(*(x.cpu() for x in env.state))
    cpu_agent = load_agent(vi_config, cpu_env, device="cpu")
    cpu_agent.act(None)
    agent.act(None)
    same_q_table("ValueIterationAgent on highway's TTC view "
                 f"({agent.state_action_value.shape[0]} states)", agent.state_action_value,
                 cpu_agent.state_action_value, exact=True)
    paths["vi_highway_agent"] = timed_agent_episode(
        dev, "ValueIterationAgent (baseline.json) on highway", env, agent,
        f", {bellman.state_action_value.iterations} updates an act (iterations "
        f"{agent.config['iterations']})")

    sailing = json.loads((CONFIGS / "SailingEnv" / "env.json").read_text())
    sailing["max_episode_steps"] = DP_AGENT_STEPS
    started = time.time()
    env = load_environment(sailing, device=dev)
    agent = load_agent(CONFIGS / "SailingEnv" / "agents" / "vi.json", env, device=dev)
    torch.cuda.synchronize()
    solve = time.time() - started
    updates = bellman.state_action_value.iterations
    cpu_agent = load_agent(CONFIGS / "SailingEnv" / "agents" / "vi.json",
                           load_environment(sailing, device="cpu"), device="cpu")
    same_q_table(f"vi.json on Sailing ({agent.mode}, {agent.state_action_value.shape[0]} states)",
                 agent.state_action_value, cpu_agent.state_action_value, exact=True)
    print(f"  Sailing solve: {updates} updates, {solve!r} s with the env")
    paths["vi_sailing_agent"] = timed_agent_episode(dev, "ValueIterationAgent (vi.json) on "
                                                    "Sailing", env, agent)

    large = CONFIGS / "FiniteMDPEnv" / "large"
    for name, config in (("RobustValueIterationAgent", "robust_value_iteration.json"),
                         ("ValueIterationAgent", "value_iteration.json")):
        env_config = json.loads((large / "env_1.json").read_text())
        env_config["max_episode_steps"] = DP_AGENT_STEPS
        env = load_environment(env_config, device=dev)
        agent = load_agent(large / "agents" / config, env, device=dev)
        cpu_agent = load_agent(large / "agents" / config,
                               load_environment(env_config, device="cpu"), device="cpu")
        same_q_table(f"{name} on FiniteMDPEnv/large", agent.state_action_value,
                     cpu_agent.state_action_value, exact=True)
        paths[f"{name}_large"] = timed_agent_episode(dev, f"{name} ({config}) on "
                                                     "FiniteMDPEnv/large", env, agent)

    # the stochastic contraction ([S, A, S] x [S]) of a random MDP, seeded
    rng = np.random.default_rng(0)
    S, A = DP_STOCHASTIC_STATES, 4
    transition = rng.random((S, A, S)).astype(np.float32)
    transition /= transition.sum(-1, keepdims=True)
    arrays = (transition, rng.normal(size=(S, A)).astype(np.float32), rng.random(S) < 0.05,
              np.zeros((), np.int64))
    tables = []
    reset_launches()
    for device in (dev, CPU):
        model = bellman.BellmanModel(*(torch.as_tensor(x, device=device) for x in arrays))
        started = time.time()
        tables.append(bellman.state_action_value(model, 0.95, "stochastic", 100).cpu().numpy())
        print(f"  stochastic MDP S={S}, A={A} on {device}: "
              f"{bellman.state_action_value.iterations} updates in {time.time() - started!r} s")
    expect_launches("stochastic value iteration", read_launches(), 0, 0)
    same_q_table(f"stochastic value iteration S={S}", tables[0], tables[1], exact=False)
    return paths


def prior_case(dev):
    """The DQN prior of MCTSWithPriorPolicyAgent/baseline.json (an MLP
    [512, 512] over highway's flattened kinematics, Boltzmann at 0.5) with
    weights drawn from a seeded generator: ``{device: (params, prior_fn)}``
    for ``dev`` and the CPU."""
    from rl_agents_torch.agents.dqn.agent import model_params
    from rl_agents_torch.agents.tree_search.mcts_with_prior import dqn_prior
    from rl_agents_torch.models.zoo import init_parameters, model_factory

    obs_dim = 15 * 5
    config = {"type": "MultiLayerPerceptron", "layers": list(PRIOR_LAYERS), "out": HW_ACTIONS}
    params = model_params(init_parameters(model_factory(dict(config), (obs_dim,)),
                                          torch.Generator().manual_seed(7)))
    return {device: ({k: v.to(device) for k, v in params.items()},
                     dqn_prior(model_factory(dict(config), (obs_dim,)).to(device),
                               PRIOR_TEMPERATURE, obs_dim))
            for device in (dev, CPU)}


def check_mcts_prior_batch_path(dev) -> dict:
    """``mcts_prior_plan_batch`` at the JAX bench's MCTS-highway size: 4096
    trees, 23 episodes x horizon 8, highway at 15 vehicles on 4 lanes, the
    [512, 512] DQN prior; 3 timed plans, one of 3 episodes profiled, the
    first 64 trees held against the CPU plan under the same noise."""
    from rl_agents_torch.agents.tree_search.mcts_with_prior import (
        mcts_prior_plan,
        mcts_prior_plan_batch,
    )
    from rl_agents_torch.utils.noise import gumbel

    env, params, states = highway_case(dev)
    priors = prior_case(dev)
    obs0 = env.observe(params(CPU), states(CPU, TREES))

    def run(device, n, noise, episodes=HW_MCTS["episodes"]):
        prior_params, prior_fn = priors[device]
        generator = None if noise is not None else torch.Generator(device=device).manual_seed(0)
        return mcts_prior_plan_batch(env, params(device), states(device, n), obs0[:n].to(device),
                                     generator, prior_params, prior_fn, noise=noise,
                                     device=device, **dict(HW_MCTS, episodes=episodes))

    E, H = HW_MCTS["episodes"], HW_MCTS["horizon"]
    work = TREES * E * H
    reset_launches()
    times = timed_plans(lambda: run(dev, TREES, None), PRIOR_PLANS)
    launches = read_launches()
    expect_launches(f"MCTS-with-prior batch path, {PRIOR_PLANS} plans", launches, 0, 0)
    forwards = mcts_prior_plan.prior_forwards
    ms = report_plans(f"mcts_prior_plan_batch on highway B={TREES} episodes={E} horizon={H}, "
                      f"DQN prior {list(PRIOR_LAYERS)}", times, work, "env-steps")
    expect(forwards == E * (H + 1), f"MCTS-with-prior plan: {forwards} prior forwards, "
                                    f"expected one per expansion and rollout step")
    print(f"  {forwards} prior forwards on [{TREES}, 75] in the last plan")
    # reading the trace takes time in proportion to its kernels: a plan of a
    # few episodes shows the same kernels at a fraction of that time
    profiled = profile_plan(lambda: run(dev, TREES, None, PRIOR_PROFILED_EPISODES),
                            host_events=False)
    print(f"  the profiled plan ran {PRIOR_PROFILED_EPISODES} of the {E} episodes: "
          f"{profiled['kernels'] / PRIOR_PROFILED_EPISODES!r} device kernels an episode")
    noise = gumbel((2, E, H, TREES, HW_ACTIONS), torch.Generator().manual_seed(5), "cpu")
    got = plan_fields(*run(dev, TREES, (noise[0], noise[1])))
    expect(((got["lengths"] >= 1) & (got["lengths"] <= HORIZON)).all()
           and (got["count"][:, 0] == E).all() and np.isfinite(got["value"]).all()
           and np.isfinite(got["prior"]).all(), "MCTS-with-prior plan: invalid lengths, "
                                               "root counts, values or priors")
    started = time.time()
    want = plan_fields(*run(CPU, CPU_SUBSET, (noise[0][..., :CPU_SUBSET, :],
                                              noise[1][..., :CPU_SUBSET, :])))
    print(f"  CPU plan of {CPU_SUBSET} trees: {time.time() - started!r} s")
    same_on_cpu("mcts_prior_plan_batch", got, want, ("actions", "lengths", "count", "parent"),
                ("value", "prior"))
    return {"launches": launches, "ms": ms, "env_steps_per_s": work / (ms / 1e3),
            "prior_forwards": forwards, "profiled_episodes": PRIOR_PROFILED_EPISODES,
            "kernels": profiled["kernels"], "busy_share": profiled["busy_share"]}


def check_mcts_prior_agent_paths(dev) -> dict:
    """``baseline.json`` with its ``model_save`` pointing at a DQN checkpoint
    written here with ``DQNAgent.save``, and ``vi_prior.json`` with the
    ``simplify`` preprocessor, 3 steps each on the uncut highway env."""
    from rl_agents_torch.factory import load_agent, load_agent_config, load_environment

    highway = json.loads((CONFIGS / "HighwayEnv" / "env.json").read_text())
    highway["max_episode_steps"] = HIGHWAY_AGENT_STEPS
    agents = CONFIGS / "HighwayEnv" / "agents" / "MCTSWithPriorPolicyAgent"
    paths = {}
    env = load_environment(highway, device=dev)
    config = load_agent_config(agents / "baseline.json")
    prior_config = dict(config["prior_agent"])
    artifact = REPO / "out" / "chip_smoke" / prior_config.pop("model_save")
    prior = load_agent(prior_config, env, device=dev)
    prior.save(artifact)
    config["prior_agent"]["model_save"] = str(artifact)
    agent = load_agent(config, env, device=dev)
    for key, value in prior.train_state.params.items():
        expect(torch.equal(agent.prior_agent.train_state.params[key], value),
               f"baseline.json did not load {key} from {artifact.name}")
    print(f"  baseline.json loads the [512, 512] prior saved at {artifact.relative_to(REPO)}; "
          f"{agent.config['episodes']} episodes x horizon {agent.config['horizon']}")
    paths["mcts_prior_dqn_agent"] = timed_agent_episode(
        dev, "MCTSWithPriorPolicyAgent (baseline.json) on highway", env, agent)
    env = load_environment(highway, device=dev)
    agent = load_agent(agents / "vi_prior.json", env, device=dev)
    expect(agent._tabular_prior and not agent._index_obs,
           "vi_prior.json does not plan with the root prior of the TTC view")
    paths["mcts_prior_vi_agent"] = timed_agent_episode(
        dev, "MCTSWithPriorPolicyAgent (vi_prior.json, simplify) on highway", env, agent)
    return paths


def params_error(got: dict, want: dict) -> float:
    """The largest difference of two parameter dicts, each leaf's relative to
    its largest entry."""
    return max(leaf_errors(got, want).values())


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's largest difference relative to its largest entry, in float64."""
    return {k: float((got[k].cpu().double() - want[k].cpu().double()).abs().max()
                     / want[k].cpu().double().abs().max().clamp(min=1e-30)) for k in want}


def float64_model(model):
    """A copy of a zoo model whose Dense layers compute in float64."""
    from rl_agents_torch.models.zoo import Dense

    twin = copy.deepcopy(model)
    for layer in twin.modules():
        if isinstance(layer, Dense):
            layer.dtype = torch.float64
    return twin


def ftq_epochs(agent, start: dict, target: dict, indices, runs: dict) -> dict:
    """One FTQ epoch for each run ``{name: (device, dtype)}``, all from the
    same start and target parameters, stepped side by side with the DQN
    train step that ``make_ftq_epoch`` loops: step i fits the minibatch
    ``indices[i]``. Returns per run its parameters after the steps in
    ``FTQ_WITNESS`` and the double-DQN argmax of each step's next states
    (``[steps, 64]``), taken before the step as the target takes it."""
    from rl_agents_torch.agents.dqn.agent import TrainState, make_train_step, q_values
    from rl_agents_torch.agents.dqn.replay import Batch
    from rl_agents_torch.models.optimizers import loss_function_factory

    gamma, double = agent.config["gamma"], agent.config["double"]
    models = {torch.float32: agent.model, torch.float64: float64_model(agent.model)}
    state, data, step_fn, model = {}, {}, {}, {}
    for name, (device, dtype) in runs.items():
        model[name] = copy.deepcopy(models[dtype]).to(device)
        step_fn[name] = make_train_step(model[name], agent.optimizer, loss_function_factory("l2"),
                                        gamma, double)[0]
        params = {k: v.to(device, dtype) for k, v in start.items()}
        state[name] = TrainState(params, {k: v.to(device, dtype) for k, v in target.items()},
                                 agent.optimizer.init(list(params.values())))
        data[name] = (Batch(*(x.to(device, dtype) if x.is_floating_point() else x.to(device)
                              for x in agent.memory.data)), indices.to(device))
    out = {name: {"params": {}, "argmax": []} for name in runs}
    for i in range(indices.shape[0]):
        for name in runs:
            memory, taken = data[name]
            batch = Batch(*(x[taken[i]] for x in memory))
            with torch.no_grad():
                best = q_values(model[name], state[name].params, batch.next_state).argmax(dim=1)
            out[name]["argmax"].append(best)
            state[name] = step_fn[name](state[name], batch)[0]
            if i + 1 in FTQ_WITNESS:
                out[name]["params"][i + 1] = {k: v.cpu() for k, v in state[name].params.items()}
    for name in runs:
        out[name]["argmax"] = torch.stack(out[name]["argmax"]).cpu()
    return out


def check_ftq(dev) -> dict:
    """``HighwayEnv/agents/FTQAgent/baseline.json`` through
    ``Evaluation(training=True).train()``: 71 episodes' worth of samples, one
    batch of at most 1000 collected and fitted once (15 epochs x
    ``FTQ_STEPS`` regression steps, the config's 400 cut for the time
    limit); then one epoch under the same indices on the card and
    on the CPU, from the fresh parameters an epoch starts from and from the
    trained ones, in float32 and in float64. The float64 epochs and the
    first step's float32 gradients are held within ``MODEL_TOLERANCE``. The
    float32 epochs are measured against each other and against the float64
    one, not held: their rounding differences grow over the steps, and where
    a double-DQN argmax is nearly tied a float32 epoch can take the other
    action and leave the float64 one. The argmax differences are counted
    step by step."""
    from rl_agents_torch.agents.dqn.agent import loss_and_gradients, model_params
    from rl_agents_torch.agents.dqn.replay import Batch
    from rl_agents_torch.factory import load_agent, load_agent_config, load_environment
    from rl_agents_torch.models.optimizers import loss_function_factory
    from rl_agents_torch.models.zoo import init_parameters
    from rl_agents_torch.trainer.evaluation import Evaluation

    env = load_environment(CONFIGS / "HighwayEnv" / "env.json", device=dev)
    config = load_agent_config(CONFIGS / "HighwayEnv" / "agents" / "FTQAgent" / "baseline.json")
    expect(config["regression_epochs"] == 400, "FTQAgent/baseline.json: not 400 regression steps")
    agent = load_agent(dict(config, regression_epochs=FTQ_STEPS), env, device=dev)
    epochs, steps = agent.value_iteration_epochs, agent.config["regression_epochs"]
    expect(agent.batched and epochs == 15 and steps == FTQ_STEPS and FTQ_WITNESS[-1] == steps,
           f"FTQ path: not 15 epochs x {FTQ_STEPS} regression steps")
    update = agent.update
    timing = {}

    def timed_update():
        torch.cuda.synchronize()
        started = time.time()
        update()
        torch.cuda.synchronize()
        timing["update_s"] = time.time() - started

    agent.update = timed_update
    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke" / "ftq",
                            num_episodes=FTQ_EPISODES, training=True, sim_seed=0)
    reset_launches()
    started = time.time()
    evaluation.train()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = read_launches()
    expect_launches("FTQ path", launches, 0, 0)
    samples = len(agent.memory)
    expect(samples == FTQ_EPISODES * 14 and "update_s" in timing,
           f"FTQ path: {samples} samples, expected one batch of {FTQ_EPISODES * 14}")
    regression = epochs * steps
    print(f"FTQAgent (baseline.json) on highway: one batch of {samples} samples, "
          f"{epochs} epochs x {steps} regression steps; train() {seconds!r} s, update() "
          f"{timing['update_s']!r} s, {timing['update_s'] / regression * 1e3!r} ms per "
          f"regression step; launches {launches}")
    expect((evaluation.run_directory / "checkpoint-final.data").is_file(),
           "FTQ path: no memory saved beside checkpoint-final.tar")

    indices = torch.randint(0, samples, (steps, 64), generator=torch.Generator().manual_seed(1))
    trained = {k: v.cpu() for k, v in agent.train_state.params.items()}
    fresh = model_params(init_parameters(copy.deepcopy(agent.model).cpu(),
                                         torch.Generator().manual_seed(11)))
    runs = {"card f32": (dev, torch.float32), "cpu f32": (CPU, torch.float32),
            "card f64": (dev, torch.float64), "cpu f64": (CPU, torch.float64)}
    pairs = (("card f32", "cpu f32"), ("cpu f32", "cpu f64"), ("card f32", "cpu f64"),
             ("card f64", "cpu f64"))
    result = {}
    for label, start, target in (("fresh", fresh, trained), ("trained", trained,
                                 {k: v.cpu() for k, v in agent.train_state.target_params.items()})):
        started = time.time()
        out = ftq_epochs(agent, start, target, indices, runs)
        print(f"  one epoch from the {label} parameters ({steps} steps, the same indices; "
              f"{time.time() - started!r} s for the {len(runs)} runs):")
        errors = {}
        for a, b in pairs:
            errors[(a, b)] = [params_error(out[a]["params"][n], out[b]["params"][n])
                              for n in FTQ_WITNESS]
            flips = (out[a]["argmax"] != out[b]["argmax"]).sum(dim=1)
            first = int(flips.nonzero()[0, 0]) + 1 if bool(flips.any()) else None
            print(f"    {a} against {b}: after steps {list(FTQ_WITNESS)} "
                  f"{[float(f'{e:.3g}') for e in errors[(a, b)]]} of a leaf's largest entry; "
                  f"double-DQN argmax differs in {int(flips.sum())} of {flips.numel() * 64} "
                  f"(first at step {first})")
        worst = leaf_errors(out["card f32"]["params"][steps], out["cpu f32"]["params"][steps])
        print(f"    card f32 against cpu f32 by leaf after {steps} steps: "
              f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }")
        result[label] = {f"{a} / {b}": e[-1] for (a, b), e in errors.items()}
        if label == "fresh":
            # the epoch the agent runs is the one stepped side by side here
            params, _, _ = agent._epoch({k: v.to(dev) for k, v in start.items()},
                                        {k: v.to(dev) for k, v in target.items()},
                                        agent.optimizer.init([v.to(dev) for v in start.values()]),
                                        agent.memory.data, samples, None, indices=indices)
            same = all(torch.equal(params[k].cpu(), out["card f32"]["params"][steps][k])
                       for k in params)
            expect(same, "FTQ: the agent's epoch on the card differs from the one stepped here")
        err = errors[("card f64", "cpu f64")][-1]
        expect(err <= MODEL_TOLERANCE, f"FTQ epoch from the {label} parameters in float64: card "
                                       f"against CPU {err!r} of a leaf's largest entry, above "
                                       f"{MODEL_TOLERANCE}")
        grads = []
        for device in (dev, CPU):
            memory = Batch(*(x.to(device) for x in agent.memory.data))
            grads.append(loss_and_gradients(
                agent.model.to(device), loss_function_factory("l2"),
                {k: v.to(device) for k, v in start.items()},
                {k: v.to(device) for k, v in target.items()},
                Batch(*(x[indices[0].to(device)] for x in memory)), agent.config["gamma"],
                agent.config["double"])[1])
        agent.model.to(dev)
        names = list(start)
        err = params_error(dict(zip(names, grads[0])), dict(zip(names, grads[1])))
        expect(err <= MODEL_TOLERANCE, f"FTQ regression step from the {label} parameters: "
                                       f"gradients on the card against the CPU's {err!r} of the "
                                       f"leaf's largest entry, above {MODEL_TOLERANCE}")
        print(f"    the first step's float32 gradients on the card within {err!r} of the CPU's")
        result[label]["first step gradients"] = err
    return {"launches": launches, "ms_per_regression_step": timing["update_s"] / regression * 1e3,
            "update_s": timing["update_s"], "epoch_errors": result}


def bftq_bench_case(device):
    """``bench_bftq_fit``'s inputs (bench.py:750-819): S = 4096 transitions of
    75 features, 3 actions, the BudgetedMLP [64, 64] with weights from a
    seed, on ``device``."""
    from rl_agents_torch.agents.budgeted_ftq.bftq import BFTQBatch
    from rl_agents_torch.agents.budgeted_ftq.models import BudgetedMLP
    from rl_agents_torch.agents.dqn.agent import model_params
    from rl_agents_torch.models.zoo import init_parameters

    S, D, A = BFTQ_STATES, 75, 3
    rng = np.random.default_rng(0)
    arrays = dict(state=rng.normal(size=(S, D)).astype(np.float32),
                  action=rng.integers(0, A, S).astype(np.int64),
                  reward=rng.uniform(size=S).astype(np.float32),
                  next_state=rng.normal(size=(S, D)).astype(np.float32),
                  terminal=rng.uniform(size=S) < 0.05,
                  cost=(rng.uniform(size=S) < 0.1).astype(np.float32),
                  beta=rng.uniform(size=S).astype(np.float32))
    batch = BFTQBatch(**{k: torch.as_tensor(v, device=device) for k, v in arrays.items()})
    network = BudgetedMLP(D, A, layers=(64, 64)).to(device)
    params = model_params(init_parameters(BudgetedMLP(D, A, layers=(64, 64)),
                                          torch.Generator().manual_seed(3)))
    return batch, network, {k: v.to(device) for k, v in params.items()}


def check_bftq(dev) -> dict:
    """BFTQ at ``bench_bftq_fit``'s sizes (the targets on the card against
    the CPU's, one target computation plus fit epoch timed), then
    ``TwoWayEnv/agents/BFTQAgent/baseline.json`` at its own width through
    ``Evaluation.train()`` for one batch, cut to 1 epoch x a few hundred
    regression steps, its target computation profiled."""
    from rl_agents_torch.agents.budgeted_ftq import bftq as bq
    from rl_agents_torch.agents.budgeted_ftq.greedy_policy import batch_mixtures, pareto_frontier
    from rl_agents_torch.factory import load_agent, load_agent_config, load_environment
    from rl_agents_torch.models.optimizers import loss_function_factory, optimizer_factory
    from rl_agents_torch.trainer.evaluation import Evaluation

    betas = {d: torch.as_tensor(bq.parse_betas(f"np.linspace(0, 1, {BFTQ_BUDGETS})"), device=d)
             for d in (dev, CPU)}
    results = {}
    reset_launches()
    for device in (dev, CPU):
        batch, network, params = bftq_bench_case(device)
        x = torch.cat([batch.next_state.repeat_interleave(BFTQ_BUDGETS, dim=0),
                       betas[device].repeat(BFTQ_STATES)[:, None]], dim=1)
        with torch.no_grad():
            q = torch.func.functional_call(network, params, (x,))
        mix = batch_mixtures(q.reshape(BFTQ_STATES, BFTQ_BUDGETS, -1), betas[device], batch.beta)
        targets = bq.compute_targets(network, params, batch, betas[device], True, 0.9, 0.9)
        results[device] = (mix, targets, q)
    (mix_d, targets_d, q_d), (mix_c, targets_c, q_c) = results[dev], results[CPU]
    q_err = float((q_d.cpu() - q_c).abs().max())
    for name in ("action_inf", "action_sup", "budget_inf", "budget_sup"):
        expect(torch.equal(getattr(mix_d, name).cpu(), getattr(mix_c, name)),
               f"BFTQ mixtures: {name} on the card differs from the CPU's (Q within {q_err!r})")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(targets_d, targets_c))
    expect(err <= BFTQ_TOLERANCE, f"BFTQ targets: card against CPU {err!r}")
    print(f"BFTQ targets at S={BFTQ_STATES}, D=75, A=3, {BFTQ_BUDGETS} budgets (P = "
          f"{BFTQ_BUDGETS * 3} hull points a state, {pareto_frontier.chunks} chunk(s)): mixture "
          f"indices equal to the CPU's, targets within {err!r}, Q within {q_err!r}")

    batch, network, params = bftq_bench_case(dev)
    optimizer = optimizer_factory("ADAM", lr=1e-3)
    loss = bq.make_loss(network, 3, loss_function_factory("l2"), loss_function_factory("l2"),
                        [1.0, 1.0])
    fit = bq.make_fit(loss, optimizer, BFTQ_REGRESSION)
    sb = torch.cat([batch.state, batch.beta[:, None]], dim=1)
    opt_state = optimizer.init(list(params.values()))

    def epoch():
        target_r, target_c = bq.compute_targets(network, params, batch, betas[dev], True, 0.9,
                                                0.9)
        return fit(params, opt_state, sb, batch.action, target_r, target_c)

    epoch()  # warm-up
    times = timed_plans(epoch)
    target_ms = cuda_ms(lambda: bq.compute_targets(network, params, batch, betas[dev], True,
                                                   0.9, 0.9), 3)
    ms = statistics.median(times)
    launches = read_launches()
    expect_launches("BFTQ fit path", launches, 0, 0)
    print(f"  target computation + fit epoch ({BFTQ_REGRESSION} ADAM steps): median {ms!r} ms "
          f"over {[round(t, 3) for t in times]}, {BFTQ_STATES / (ms / 1e3)!r} states/s; the "
          f"targets alone {target_ms!r} ms")

    env_config = load_agent_config(CONFIGS / "TwoWayEnv" / "env.json")
    env = load_environment(env_config, device=dev)
    config = load_agent_config(CONFIGS / "TwoWayEnv" / "agents" / "BFTQAgent" / "baseline.json")
    config.update(epochs=BFTQ_AGENT_EPOCHS, regression_epochs=BFTQ_AGENT_REGRESSION)
    agent = load_agent(config, env, device=dev)
    calls = []
    update = agent.update

    def recorded_update():  # train() resets the fitter, then fits through update()
        compute = agent.bftq.compute_targets

        def recorded(batch, bootstrap):  # run() takes each epoch's targets through this
            torch.cuda.synchronize()
            started = time.time()
            targets = compute(batch, bootstrap)
            torch.cuda.synchronize()
            calls.append((batch.state.shape[0], bootstrap, time.time() - started))
            return targets

        agent.bftq.compute_targets = recorded
        update()
        del agent.bftq.compute_targets

    agent.update = recorded_update
    evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke" / "bftq",
                            num_episodes=BFTQ_AGENT_EPISODES, training=True, sim_seed=0)
    reset_launches()
    started = time.time()
    evaluation.train()
    torch.cuda.synchronize()
    seconds = time.time() - started
    agent_launches = read_launches()
    expect_launches("BFTQ agent path", agent_launches, 0, 0)
    bftq = agent.bftq
    width = bftq.betas_for_discretisation.shape[0] * env.action_space.n
    samples = bftq.memory_size
    expect([c[:2] for c in calls] == [(samples, e > 0) for e in range(BFTQ_AGENT_EPOCHS)],
           f"BFTQ agent path: target computations {calls}, expected one an epoch over the "
           f"{samples} transitions, bootstrapped from the second")
    print(f"BFTQAgent (TwoWayEnv baseline.json, cut to {BFTQ_AGENT_EPOCHS} epochs x "
          f"{BFTQ_AGENT_REGRESSION} regression steps from 15 x 5000, {BFTQ_AGENT_EPISODES} "
          f"episodes) through train(): {samples} transitions ({BFTQ_AGENT_EPISODES * 14} samples "
          f"x {len(bftq.betas_for_duplication)} duplicated budgets), {width} hull points a "
          f"state, {seconds!r} s; the bootstrapped epoch's targets {calls[-1][2]!r} s "
          f"({pareto_frontier.chunks} hull blocks)")
    agent_batch = bftq._zip_batch()
    subset = bq.BFTQBatch(*(x[:BFTQ_PROFILED] for x in agent_batch))
    profiled_targets = []
    profiled = profile_plan(lambda: profiled_targets.append(bftq.compute_targets(subset, True)),
                            host_events=False)
    print(f"  profiled target computation of {BFTQ_PROFILED} transitions at P = {width}: "
          f"{pareto_frontier.chunks} hull blocks, {profiled['wall_ms']!r} ms")
    # the first transitions' mixtures and targets against the CPU's; the
    # CPU's hull takes most of a second a state at P = 500
    held = bq.BFTQBatch(*(x[:BFTQ_HELD] for x in subset))

    def mixture_and_targets(network, params, batch, device):
        disc = bftq.betas_for_discretisation.to(device)
        mix = bq.next_mixtures(network, params, batch, disc)
        return mix, bq.mixture_targets(mix, batch, bftq.config["gamma"], bftq.config["gamma_c"],
                                       bftq.config.get("clamp_qc"))

    started = time.time()
    cpu_params = {k: v.cpu() for k, v in bftq.params.items()}
    mixes, targets = {}, {}
    mixes[CPU], targets[CPU] = mixture_and_targets(copy.deepcopy(bftq.network).cpu(), cpu_params,
                                                   bq.BFTQBatch(*(x.cpu() for x in held)), CPU)
    cpu_s = time.time() - started
    mixes[dev], targets[dev] = mixture_and_targets(bftq.network, bftq.params, held, dev)
    for name in ("action_inf", "action_sup", "budget_inf", "budget_sup"):
        expect(torch.equal(getattr(mixes[dev], name).cpu(), getattr(mixes[CPU], name)),
               f"BFTQ mixtures at P = {width}: {name} on the card differs from the CPU's")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(targets[dev], targets[CPU]))
    profiled_err = max(float((a[:BFTQ_HELD].cpu() - b).abs().max())
                       for a, b in zip(profiled_targets[0], targets[CPU]))
    expect(max(err, profiled_err) <= BFTQ_TOLERANCE,
           f"BFTQ targets at P = {width}: card against CPU {max(err, profiled_err)!r}")
    print(f"  the first {BFTQ_HELD} of them against the CPU ({cpu_s!r} s there): mixture indices "
          f"equal, targets within {profiled_err!r} (the profiled run) and {err!r}")
    launches = {k: v + agent_launches[k] for k, v in launches.items()}
    return {"launches": launches, "epoch_ms": ms, "states_per_s": BFTQ_STATES / (ms / 1e3),
            "targets_ms": target_ms, "agent_s": seconds, "agent_bootstrapped_s": calls[-1][2],
            "agent_target_busy_share": profiled["busy_share"], "agent": agent,
            "state": held.state[0].cpu().numpy()}


# ---------------------------------------------------------------------------
# Slice 8: the remaining planners and the parity modes. None reaches a
# Pallas kernel in the JAX package, so none launches a hand kernel here.
# ---------------------------------------------------------------------------

SLICE8_AGENT_STEPS = 3
BRUE_AGENT_STEPS = 1  # brue.json's agent takes ~4.5 s an act(): cut for the time limit
BRUE_CHAIN = 64  # positions of BRUE's injected draw chain (past it the last one repeats)
TB_BATCH, TB_BUDGET = 512, 500  # bench_trailblazer_batched (bench.py:624-671)
TB_KW = dict(gamma=0.5, delta=0.1, epsilon=4.0, max_oracle_calls=TB_BUDGET)
LOOP_MDP = {"mode": "deterministic",
            "transition": [[0, 1, 2], [0, 3, 2], [0, 1, 3], [3, 1, 2]],
            "reward": [[0, 1, 0.9], [0, 0, 0.9], [0, 1, 0], [0, 1, 0.9]],
            "terminal": [0, 0, 0, 0], "max_episode_steps": 10_000}
TIE_MDP = {"mode": "deterministic", "transition": [[1, 2, 0], [1, 3, 3], [2, 3, 3], [3, 3, 3]],
           "reward": [[0.5, 0.5, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0, 0, 0]],
           "terminal": [0, 0, 0, 0], "max_episode_steps": 100}
PCG_STREAMS, PCG_DRAWS = 64, 1024  # 2^16 raw draws
PARITY_SEEDS = list(range(16))
MCTS_PARITY = dict(num_actions=3, episodes=25, horizon=6, gamma=0.8, temperature=10.0)
OLOP_PARITY = dict(num_actions=3, episodes=12, horizon=4, gamma=0.8, continuation_uniform=True)
OPD_PARITY = dict(num_actions=3, expansions=3, gamma=0.5, plan_capacity=8)


def slice8_batch_path(name: str, plan, work: int, unit: str, profiled=None,
                      count: int = PLANS) -> dict:
    """``count`` timed plans with the KL counters zeroed before and read
    after (0 launches asserted), then one profiled plan (``profiled``, a
    shorter plan where a whole one has too many kernels to trace)."""
    reset_launches()
    times = timed_plans(plan, count)
    launches = read_launches()
    expect_launches(name, launches, 0, 0)
    ms = report_plans(f"{name}", times, work, unit)
    prof = profile_plan(profiled or plan, host_events=False)
    expect(prof["kl_launches"] == 0, f"{name}: the profiler saw KL kernels")
    return {"launches": launches, "ms": ms, "kernels": prof["kernels"],
            "busy_share": prof["busy_share"]}


def tree_fields(action, tree) -> dict:
    from rl_agents_torch.convert import tree_to_numpy

    return dict(tree_to_numpy(tree)._asdict(), actions=action.cpu().numpy())


def cut_trees(noise, n: int, axis: int):
    """The first ``n`` trees of every array of a noise NamedTuple, on the CPU."""
    return type(noise)(*(None if x is None else x.narrow(axis, 0, n).cpu() for x in noise))


def dpw_noise(dev, episodes, horizon, trees, num_actions, width, seed, expand=True):
    """``DPWNoise`` for Sailing drawn on the card from a seed: Gumbel draws,
    the random slot for each slot count, and the wind's uniforms."""
    from rl_agents_torch.agents.tree_search.mcts_dpw import DPWNoise
    from rl_agents_torch.utils.noise import gumbel, uniform

    g = torch.Generator(device=dev).manual_seed(seed)
    E, H, B, A, W = episodes, horizon, trees, num_actions, width
    draws = gumbel((3, E, H, B, A), g, dev)
    u = uniform((E, H, B, 1), g, dev)
    slot = torch.floor(u * torch.arange(1, W + 1, device=dev)).to(torch.int64)
    return DPWNoise(expand=draws[2] if expand else None, select=draws[0], slot=slot,
                    env=uniform((E, H, B), g, dev), rollout=draws[1],
                    rollout_env=uniform((E, H, B), g, dev))


def check_mcts_dpw_path(dev) -> dict:
    """MCTS-DPW at ``MCTSDPWAgent``'s defaults (budget 100, gamma 0.95: 5
    episodes x horizon 16, temperature 1, k 3 / 1, alpha 0.3, 8 outcome
    slots) on Sailing, 4096 trees; the first 64 against the CPU plan under
    the same draws."""
    from rl_agents_torch.agents.tree_search.batch import mcts_dpw_plan_batch
    from rl_agents_torch.agents.tree_search.common import allocation
    from rl_agents_torch.agents.tree_search.mcts_dpw import MCTSDPWAgent

    config = MCTSDPWAgent.default_config()
    episodes, horizon = allocation(config["budget"], config["gamma"])
    env, params, states = sailing_case(dev)
    probs = torch.ones(SAILING_ACTIONS) / SAILING_ACTIONS
    kw = dict(num_actions=SAILING_ACTIONS, episodes=episodes, horizon=horizon,
              gamma=config["gamma"], temperature=config["temperature"],
              k_action=config["k_action"], alpha_action=config["alpha_action"],
              k_state=config["k_state"], alpha_state=config["alpha_state"],
              width=config["max_next_states_count"])
    states0 = states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: mcts_dpw_plan_batch(env, params, states0, generator, probs, device=dev, **kw)
    plan()  # warm-up
    result = slice8_batch_path(f"mcts_dpw_plan_batch B={TREES} episodes={episodes} "
                               f"horizon={horizon}", plan, TREES * episodes * horizon, "env-steps")
    noise = dpw_noise(dev, episodes, horizon, TREES, SAILING_ACTIONS, kw["width"], 7)
    got = tree_fields(*mcts_dpw_plan_batch(env, params, states0, None, probs, noise=noise,
                                           device=dev, **kw))
    expect((got["d_count"][:, 0] == episodes).all() and np.isfinite(got["d_value"]).all(),
           "MCTS-DPW plan: invalid root counts or values")
    want = tree_fields(*mcts_dpw_plan_batch(env, env.default_params(CPU), states(CPU, CPU_SUBSET),
                                            None, probs, noise=cut_trees(noise, CPU_SUBSET, 2),
                                            device=CPU, **kw))
    same_on_cpu("mcts_dpw_plan_batch", got, want,
                ("actions", "d_count", "d_children", "c_count", "c_child_keys", "c_children"),
                ("d_value", "c_value"), CPU_SUBSET)
    return result


def check_closed_loop_paths(dev) -> dict:
    """Closed-loop MCTS on the uncut highway (15 vehicles, 4 lanes) at the
    bench's 4096 trees x 23 x 8, its observations keyed in 8 slots per
    action; the first 64 trees against the CPU plan under the same draws;
    then ``MCTSAgent/closed_loop.json`` for 3 steps."""
    from rl_agents_torch.agents.tree_search.batch import mcts_closed_loop_plan_batch
    from rl_agents_torch.factory import load_agent, load_environment

    env, params, states = highway_case(dev)
    probs = torch.ones(HW_ACTIONS) / HW_ACTIONS
    kw = dict(num_actions=HW_ACTIONS, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA,
              temperature=MCTS_TEMPERATURE, width=8)
    p, states0 = params(dev), states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: mcts_closed_loop_plan_batch(env, p, states0, generator, probs, probs,
                                               device=dev, **kw)
    short = lambda: mcts_closed_loop_plan_batch(env, p, states0, generator, probs, probs,
                                                device=dev, **dict(kw, episodes=3))
    result = slice8_batch_path(f"mcts_closed_loop_plan_batch on highway B={TREES} "
                               f"episodes={EPISODES} horizon={HORIZON}", plan,
                               TREES * EPISODES * HORIZON, "env-steps", profiled=short,
                               count=CLOSED_LOOP_PLANS)
    print(f"  the profiled plan ran 3 of {EPISODES} episodes")
    noise = dpw_noise(dev, EPISODES, HORIZON, TREES, HW_ACTIONS, kw["width"], 9, expand=False)
    noise = noise._replace(env=None, rollout_env=None)  # highway draws nothing
    got = tree_fields(*mcts_closed_loop_plan_batch(env, p, states0, None, probs, probs,
                                                   noise=noise, device=dev, **kw))
    expect((got["d_count"][:, 0] == EPISODES).all() and np.isfinite(got["d_value"]).all(),
           "closed-loop MCTS plan: invalid root counts or values")
    started = time.time()
    want = tree_fields(*mcts_closed_loop_plan_batch(
        env, params(CPU), states(CPU, CPU_SUBSET), None, probs, probs,
        noise=cut_trees(noise, CPU_SUBSET, 2), device=CPU, **kw))
    print(f"  CPU plan of {CPU_SUBSET} trees: {time.time() - started!r} s")
    same_on_cpu("mcts_closed_loop_plan_batch", got, want,
                ("actions", "d_count", "d_children", "c_count", "c_child_keys", "c_children"),
                ("d_value", "c_value"), CPU_SUBSET)
    highway = json.loads((CONFIGS / "HighwayEnv" / "env.json").read_text())
    highway["max_episode_steps"] = SLICE8_AGENT_STEPS
    handle = load_environment(highway, device=dev)
    agent = load_agent(CONFIGS / "HighwayEnv" / "agents" / "MCTSAgent" / "closed_loop.json",
                       handle, device=dev)
    expect(agent.config["closed_loop"], "closed_loop.json: not closed loop")
    agent_result = timed_agent_episode(
        dev, "MCTSAgent (closed_loop.json) on highway", handle, agent,
        f", {agent.config['episodes']} episodes x horizon {agent.config['horizon']}")
    return {"closed_loop_batch_plans": result, "closed_loop_agent": agent_result}


def check_brue_paths(dev) -> dict:
    """``SailingEnv/agents/brue.json`` (budget 200 env steps, gamma 0.99: a
    horizon of 55, arenas of 11,001 nodes) on ``SailingEnv/env.json``: 4096
    trees from the env's reset states, the first 64 against the CPU plan
    under the same draws; then the agent for 3 steps."""
    from rl_agents_torch.agents.tree_search.batch import brue_plan_batch
    from rl_agents_torch.agents.tree_search.brue import BRUENoise
    from rl_agents_torch.agents.tree_search.common import allocation
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.utils.noise import gumbel, uniform

    config = json.loads((CONFIGS / "SailingEnv" / "agents" / "brue.json").read_text())
    _, horizon = allocation(config["budget"], config["gamma"])
    env, params, _ = sailing_case(dev)
    start, _ = env.reset(env.default_params(CPU), torch.Generator().manual_seed(6), TREES)

    def states(device, n):
        return type(start)(*(x[:n].to(device) for x in start))

    kw = dict(num_actions=SAILING_ACTIONS, budget=config["budget"], horizon=horizon,
              gamma=config["gamma"], width=8)
    states0 = states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    g = torch.Generator(device=dev).manual_seed(8)
    I, B, H, W, A = BRUE_CHAIN, TREES, horizon, 8, SAILING_ACTIONS
    noise = BRUENoise(rollout_actions=torch.randint(0, A, (I, B, H), generator=g, device=dev),
                      rollout_env=uniform((I, B, H), g, dev),
                      estimate=gumbel((I, B, H, W), g, dev), final=gumbel((I, B, A), g, dev))
    # the timed plan is the one held against the CPU
    outs = []
    short = lambda: brue_plan_batch(env, params, states0, generator, device=dev,
                                    **dict(kw, budget=1))
    result = slice8_batch_path(
        f"brue_plan_batch B={TREES} budget={config['budget']} horizon={horizon}",
        lambda: outs.append(brue_plan_batch(env, params, states0, None, noise=noise, device=dev,
                                            **kw)),
        TREES * config["budget"], "budgeted env-steps", profiled=short, count=1)
    print("  the profiled plan ran one episode (budget 1)")
    got = tree_fields(*outs[0])
    expect(np.isfinite(got["c_value"]).all() and got["c_count"][:, 0].sum() > 0,
           "BRUE plan: invalid values")
    started = time.time()
    want = tree_fields(*brue_plan_batch(env, env.default_params(CPU), states(CPU, CPU_SUBSET),
                                        None, noise=cut_trees(noise, CPU_SUBSET, 1), device=CPU,
                                        **kw))
    print(f"  CPU plan of {CPU_SUBSET} trees: {time.time() - started!r} s")
    same_on_cpu("brue_plan_batch", got, want,
                ("actions", "d_count", "d_children", "c_count", "c_child_keys", "c_children",
                 "d_used", "c_used"), ("d_reward", "c_value"), CPU_SUBSET)
    sailing = json.loads((CONFIGS / "SailingEnv" / "env.json").read_text())
    sailing["max_episode_steps"] = BRUE_AGENT_STEPS
    handle = load_environment(sailing, device=dev)
    agent = load_agent(CONFIGS / "SailingEnv" / "agents" / "brue.json", handle, device=dev)
    agent_result = timed_agent_episode(dev, "BRUEAgent (brue.json) on Sailing", handle, agent)
    return {"brue_batch_plans": result, "brue_agent": agent_result}


def check_sparse_sampling_paths(dev) -> dict:
    """``FiniteMDPEnv/agents/sparse_sampling.json`` (C = 3, horizon 3, gamma
    0.7) on the garnet of ``env_garnet.json``: 4096 trees, 1,728 sampled
    transitions at the last level of each, the first 64 against the CPU plan
    under the same draws; then the agent for 3 steps."""
    from rl_agents_torch.agents.tree_search.batch import sparse_sampling_plan_batch
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.utils.noise import gumbel

    config = json.loads((CONFIGS / "FiniteMDPEnv" / "agents" / "sparse_sampling.json")
                        .read_text())
    env, params, states = garnet_case(dev, branching=2)
    A, C, H = GAPE["num_actions"], config["C"], config["horizon"]
    kw = dict(num_actions=A, horizon=H, samples=C, gamma=config["gamma"])
    states0 = states(dev, TREES)
    generator = torch.Generator(device=dev).manual_seed(0)
    plan = lambda: sparse_sampling_plan_batch(env, params, states0, generator, device=dev, **kw)
    plan()  # warm-up
    work = TREES * sum((A * C) ** (d + 1) for d in range(H))
    result = slice8_batch_path(f"sparse_sampling_plan_batch B={TREES} C={C} horizon={H}", plan,
                               work, "env-steps")
    g = torch.Generator(device=dev).manual_seed(10)
    noise = [gumbel((TREES, (A * C) ** d, A, C, 2), g, dev) for d in range(H)]
    action, q = sparse_sampling_plan_batch(env, params, states0, None, noise=noise, device=dev,
                                           **kw)
    got = {"actions": action.cpu().numpy(), "q": q.cpu().numpy()}
    expect(np.isfinite(got["q"]).all(), "sparse sampling: invalid Q values")
    action, q = sparse_sampling_plan_batch(env, params.__class__(*(v.cpu() for v in params)),
                                           states(CPU, CPU_SUBSET), None,
                                           noise=[n[:CPU_SUBSET].cpu() for n in noise],
                                           device=CPU, **kw)
    same_on_cpu("sparse_sampling_plan_batch", got, {"actions": action.numpy(), "q": q.numpy()},
                ("actions",), ("q",), CPU_SUBSET)
    garnet = json.loads((CONFIGS / "FiniteMDPEnv" / "env_garnet.json").read_text())
    garnet["max_episode_steps"] = SLICE8_AGENT_STEPS
    handle = load_environment(garnet, device=dev)
    agent = load_agent(CONFIGS / "FiniteMDPEnv" / "agents" / "sparse_sampling.json", handle,
                       device=dev)
    agent_result = timed_agent_episode(dev, "SparseSamplingAgent on the garnet", handle, agent)
    return {"sparse_sampling_batch_plans": result, "sparse_sampling_agent": agent_result}


def to_cpu_handle(handle, cpu_handle):
    """Stamp a card handle's state into a CPU handle of the same env."""
    cpu_handle.state = type(handle.state)(*(x.cpu() for x in handle.state))
    return cpu_handle


def check_cem_paths(dev) -> dict:
    """``CartPoleEnv/CEMAgent.json`` and ``HighwayEnv/agents/CEMAgent/cem.json``,
    3 steps each through ``act()``; before each step the plan on the card
    against the CPU's from the same state under the same normals (the mean
    within 1e-5, the plan ``mean > 0.5`` equal)."""
    from rl_agents_torch.agents.cem import CEMNoise, cem_plan
    from rl_agents_torch.factory import load_agent, load_environment

    result = {}
    for key, env_file, agent_file in (
            ("cem_cartpole_agent", CONFIGS / "CartPoleEnv" / "env.json",
             CONFIGS / "CartPoleEnv" / "CEMAgent.json"),
            ("cem_highway_agent", CONFIGS / "HighwayEnv" / "env.json",
             CONFIGS / "HighwayEnv" / "agents" / "CEMAgent" / "cem.json")):
        handle = load_environment(env_file, device=dev)
        cpu_handle = load_environment(env_file, device=CPU)
        agent = load_agent(agent_file, handle, device=dev)
        c = agent.config
        kw = dict(horizon=c["horizon"], iterations=c["iterations"], candidates=c["candidates"],
                  top_candidates=c["top_candidates"], gamma=c["gamma"],
                  action_size=agent.action_size, discrete=agent.discrete)
        handle.reset(seed=0)
        reset_launches()
        seconds, worst = [], 0.0
        for step in range(SLICE8_AGENT_STEPS):
            g = torch.Generator(device=dev).manual_seed(20 + step)
            normals = torch.randn((kw["iterations"], 1, kw["candidates"], kw["horizon"],
                                   kw["action_size"]), generator=g, device=dev)
            mean, _ = cem_plan(handle.functional, handle.params, handle.state, None,
                               noise=CEMNoise(normals, None), device=dev, **kw)
            cpu = to_cpu_handle(handle, cpu_handle)
            want, _ = cem_plan(cpu.functional, cpu.params, cpu.state, None,
                               noise=CEMNoise(normals.cpu(), None), device=CPU, **kw)
            worst = max(worst, float((mean.cpu() - want).abs().max()))
            expect(agent.plan_from_mean(mean[0]) == agent.plan_from_mean(want[0]),
                   f"{key}: the plan differs from the CPU plan")
            torch.cuda.synchronize()
            started = time.time()
            action = agent.act(None)
            torch.cuda.synchronize()
            seconds.append(time.time() - started)
            handle.step(action)
        launches = read_launches()
        expect_launches(key, launches, 0, 0)
        expect(worst <= KL_TOLERANCE, f"{key}: mean {worst!r} from the CPU's")
        per_act = statistics.median(seconds)
        print(f"{key}: {c['iterations']} iterations x {c['candidates']} candidates x horizon "
              f"{c['horizon']}; median {per_act!r} s per act(); plans equal to the CPU's, mean "
              f"within {worst!r}; launches {launches}")
        result[key] = {"launches": launches, "s_per_act": per_act}
    return result


def check_platypoos_path(dev) -> dict:
    """``HighwayEnv/agents/PlaTyPOOSAgent/baseline.json`` (budget 2500, gamma
    0.9, ``simplify``) on ``HighwayEnv/env.json`` for 3 steps; each plan
    against a CPU agent's from the same state."""
    from rl_agents_torch.factory import load_agent, load_environment

    env_file = CONFIGS / "HighwayEnv" / "env.json"
    agent_file = CONFIGS / "HighwayEnv" / "agents" / "PlaTyPOOSAgent" / "baseline.json"
    handle = load_environment(env_file, device=dev)
    cpu_handle = load_environment(env_file, device=CPU)
    agent = load_agent(agent_file, handle, device=dev)
    cpu_agent = load_agent(agent_file, cpu_handle, device=CPU)
    handle.reset(seed=0)
    reset_launches()
    seconds, steps = [], []
    for _ in range(SLICE8_AGENT_STEPS):
        torch.cuda.synchronize()
        started = time.time()
        plan = agent.plan(None)
        torch.cuda.synchronize()
        seconds.append(time.time() - started)
        steps.append(agent.env_steps)
        to_cpu_handle(handle, cpu_handle)
        expect(plan == cpu_agent.plan(None), "PlaTyPOOS: the plan differs from the CPU plan")
        handle.step(plan[0])
    launches = read_launches()
    expect_launches("PlaTyPOOS agent path", launches, 0, 0)
    per_act = statistics.median(seconds)
    print(f"PlaTyPOOSAgent (baseline.json) on highway: horizon {agent.config['horizon']}, "
          f"median {per_act!r} s per plan, {steps} env transitions a plan (padding included), "
          f"{agent.openings} openings in the last; plans equal to the CPU's; launches {launches}")
    return {"launches": launches, "s_per_act": per_act, "env_steps": steps[-1]}


def check_trailblazer_path(dev) -> dict:
    """``BatchedTrailBlazer`` at the JAX bench's 512 lockstep instances on the
    loop MDP (gamma 0.5, delta 0.1, epsilon 4, oracle budget 500); the first
    64 instances' values against a CPU run of the same 64."""
    from rl_agents_torch.agents.tree_search.trailblazer import BatchedTrailBlazer, TrailBlazer
    from rl_agents_torch.envs.finite_mdp import make

    handle = make(LOOP_MDP, device=dev)
    single = TrailBlazer(handle, **TB_KW)
    single.run()
    reset_launches()
    torch.cuda.synchronize()
    started = time.time()
    batched = BatchedTrailBlazer(handle, [handle.state] * TB_BATCH, **TB_KW)
    values = batched.run()
    torch.cuda.synchronize()
    seconds = time.time() - started
    launches = read_launches()
    expect_launches("TrailBlazer path", launches, 0, 0)
    cpu = make(LOOP_MDP, device=CPU)
    want = BatchedTrailBlazer(cpu, [cpu.state] * CPU_SUBSET, **TB_KW).run()
    expect(np.array_equal(values[:CPU_SUBSET], want) and np.isfinite(values).all(),
           "TrailBlazer: the values differ from the CPU run")
    rate = TB_BATCH / seconds
    print(f"BatchedTrailBlazer B={TB_BATCH} oracle budget {TB_BUDGET}: {seconds!r} s, "
          f"{rate!r} plans/s, {batched.dispatches / TB_BATCH!r} dispatches per plan "
          f"({batched.dispatches} rounds; one instance alone: {single.dispatches}), root value "
          f"{values[0]!r}; the first {CPU_SUBSET} equal to the CPU run; launches {launches}")
    return {"launches": launches, "plans_per_s": rate,
            "dispatches_per_plan": batched.dispatches / TB_BATCH}


def check_parity_paths(dev) -> dict:
    """PCG64 on the card: 2^16 raw draws (64 streams x 1,024), then bounded
    integers and doubles, bit-equal to numpy's ``Generator(PCG64)``; the
    MCTS, OLOP and OPD parity plans in float64 for 16 seeds on the card
    against the same plans on the CPU: actions, counts, stream digits equal,
    float64 fields within 1e-12."""
    from rl_agents_torch.agents.tree_search.deterministic import opd_plan_parity
    from rl_agents_torch.agents.tree_search.mcts_parity import mcts_plan_parity
    from rl_agents_torch.agents.tree_search.olop_parity import olop_plan_parity
    from rl_agents_torch.envs.finite_mdp import MDPState, params_from_config
    from rl_agents_torch.utils.pcg64 import (
        pcg64_double,
        pcg64_init,
        pcg64_integers,
        pcg64_next64,
    )

    reset_launches()
    seeds = list(range(PCG_STREAMS))
    stream, inc = pcg64_init(seeds, device=dev)
    torch.cuda.synchronize()
    started = time.time()
    hi, lo = [], []
    for _ in range(PCG_DRAWS):
        stream, (h, l) = pcg64_next64(stream, inc)
        hi.append(h)
        lo.append(l)
    torch.cuda.synchronize()
    seconds = time.time() - started
    got = (torch.stack(hi, 1).cpu().numpy().astype(np.uint64) << np.uint64(32)) \
        | torch.stack(lo, 1).cpu().numpy().astype(np.uint64)
    want = np.stack([np.random.PCG64(s).random_raw(PCG_DRAWS) for s in seeds])
    expect(np.array_equal(got, want), "PCG64 raw draws differ from numpy's")
    gens = [np.random.Generator(np.random.PCG64(s)) for s in seeds]
    for g in gens:
        g.bit_generator.random_raw(PCG_DRAWS)
    bounds = np.random.default_rng(0).integers(2, 2 ** 32 - 1, (64, PCG_STREAMS))
    for n in bounds:
        stream, v = pcg64_integers(stream, inc, torch.tensor(n, device=dev))
        expect(v.tolist() == [int(g.integers(0, int(k))) for g, k in zip(gens, n)],
               "PCG64 integers differ from numpy's")
        stream, d = pcg64_double(stream, inc)
        expect(d.tolist() == [g.random() for g in gens], "PCG64 doubles differ from numpy's")
    print(f"PCG64: {PCG_STREAMS * PCG_DRAWS} raw draws in {seconds!r} s "
          f"({PCG_DRAWS} steps of {PCG_STREAMS} streams), then 64 bounded integers and 64 "
          f"doubles a stream: bit-equal to numpy's Generator(PCG64)")

    plans = {}
    for name, config, fn, kw in (("mcts_parity", LOOP_MDP, mcts_plan_parity, MCTS_PARITY),
                                 ("olop_parity", LOOP_MDP, olop_plan_parity, OLOP_PARITY),
                                 ("opd_parity", TIE_MDP, opd_plan_parity, OPD_PARITY)):
        out = []
        for device in (dev, CPU):
            env, params = params_from_config(config, device=device)
            n = len(PARITY_SEEDS)
            state = MDPState(*(torch.zeros(n, dtype=dtype, device=device)
                               for dtype in (torch.int64, torch.int64, torch.bool)))
            stream, inc = pcg64_init(PARITY_SEEDS, device=device)
            torch.cuda.synchronize()
            started = time.time()
            result = fn(env, params, state, stream, inc, device=device, **kw)
            torch.cuda.synchronize()
            out.append((result, time.time() - started))
        (card, card_s), (cpu, cpu_s) = out
        actions, lengths, arena, stream = card[:4]
        expect(torch.equal(actions.cpu(), cpu[0]) and torch.equal(lengths.cpu(), cpu[1]),
               f"{name}: the plans differ from the CPU's")
        expect(torch.equal(stream.digits.cpu(), cpu[3].digits)
               and torch.equal(stream.buf.cpu(), cpu[3].buf), f"{name}: the streams differ")
        worst = 0.0
        fields = [(f, v, getattr(cpu[2], f)) for f, v in arena._asdict().items()
                  if isinstance(v, torch.Tensor)]
        for field, value, want in fields:
            if value.is_floating_point():
                worst = max(worst, float((value.cpu() - want).abs().max()))
            else:
                expect(torch.equal(value.cpu(), want), f"{name}: {field} differs")
        expect(worst <= 1e-12, f"{name}: float64 fields {worst!r} from the CPU's")
        print(f"{name}: {len(PARITY_SEEDS)} seeds, {card_s!r} s on the card, {cpu_s!r} s on the "
              f"CPU; plans, counts and stream digits equal, float64 fields within {worst!r}")
        plans[name] = card_s
    launches = read_launches()
    expect_launches("PCG64 and parity paths", launches, 0, 0)
    return {"launches": launches, "pcg64_raw_s": seconds, "parity_plan_s": plans}


# ---------------------------------------------------------------------------
# Slice 9: the remaining envs and robust control. The KL kernel runs in both
# forms on the new envs' planners; the envs, the interval predictor and the
# LMI solver are tensor functions, as the JAX package computes them outside
# any Pallas kernel.
# ---------------------------------------------------------------------------

SLICE9_AGENT_STEPS = 3
GRIDWORLD = CONFIGS / "GridWorld"
DUMMY = CONFIGS / "DummyEnv"
# KL-OLOP at GridWorld/agents/kl-olop.json: budget 500 at gamma 0.8 is 55
# episodes x horizon 9 (its max_depth 4 is read by neither package), the
# default threshold 4 log(time) (its "c" is no threshold), uniform continuation
MG_OLOP = dict(num_actions=3, episodes=55, horizon=9, gamma=0.8, threshold_coeff=4.0,
               continuation_uniform=True)
MG_RECORDED = (0, 27, 54)  # episodes whose kl_bound_indexed_ inputs phase 3 checks
MG_PROFILED = 5  # episodes of the profiled plan
# MDP-GapE at DummyEnv/agents/mdp-gape.json on gridenv_stoch.json: budget 200
# at gamma 0.7 is 35 episodes x horizon 5, two next-state slots, confidence 1
GRID_GAPE = dict(num_actions=4, episodes=35, horizon=5, gamma=0.7, accuracy=0.0, confidence=1.0,
                 transition_threshold_coeff=0.1, width=2)
GRID_GAPE_KL_LAUNCHES = GRID_GAPE["episodes"] + 1  # kl_bounds_pair_, one an episode
DUMMY_OLOP_EPISODES = 35  # DummyEnv/agents/kl-olop.json: budget 200 at gamma 0.7
PENDULUM_OLOP_EPISODES = 15  # Pendulum/OLOPAgent.json: budget 200 at gamma 0.9
LPV_STEPS = 40
LPV_TOLERANCE = 1e-6  # relative to the interval's largest entry
# the robust fork's polytope of ObstacleEnv/RobustEPCAgent.json before any data
LPV_SYSTEM = dict(a0=[[0.0, 1.0], [0.0, 0.0]], da=[[[0.0, 0.0], [0.0, -1.0]],
                                                     [[0.0, 0.0], [0.0, 1.0]]],
                  b=[[0.0], [1.0]], d=[[0.0], [1.0]], omega=[[0.01], [0.01]])
# tests/agents/test_lmi.py's systems (its fourth case, the IntervalFeedbackAgent,
# synthesizes the same stable system) and tests/agents/test_robust.py:133-156's agent
LMI_STABLE = dict(A0=[[-1.0, 1.0], [0.0, -2.0]], dA=[[[0.0, 0.0], [0.0, 0.1]]], B=[[0.0], [1.0]])
LMI_UNSTABLE = dict(A0=[[0.0, 1.0], [0.0, 0.0]], dA=[[[0.0, 0.0], [0.0, 0.1]]],
                    B=[[0.0], [1.0]])
LMI_CASES = (("analysis, stable", LMI_STABLE, False, 8000),
             # cut from 2,000 steps for the time limit (PERF.md §4): the
             # unstable system is refused after any number of steps
             ("analysis, unstable", LMI_UNSTABLE, False, 1000),
             ("synthesis, stable", LMI_STABLE, True, 8000))
EPC_TEST = {"A": [[0.0, 1.0], [0.0, 0.0]], "B": [[0.0], [1.0]], "D": [[0.0], [1.0]],
            "phi": [[[0.0, 0.0], [0.0, -1.0]]], "sigma": [[1.0, 0.0], [0.0, 1.0]],
            "omega": [[0.0], [0.0]], "parameter_box": [[0.0], [1.0]], "noise_bound": 0.1,
            "sub_agent": {"__class__": "DeterministicPlannerAgent", "budget": 10, "gamma": 0.9}}


def minigrid_case(dev):
    """``MiniGrid-Empty-16x16-v0`` (``GridWorld/empty.json``) on ``dev``,
    ``TREES`` start cells and headings from a seed, and the plan's injected
    draws: the continuation actions and the env's drop uniforms (the grid
    drops nothing: its stochasticity is 0)."""
    from rl_agents_torch.envs.minigrid import MiniGridState, make

    env = make(json.loads((GRIDWORLD / "empty.json").read_text()), device=CPU).functional
    rng = np.random.default_rng(5)
    pos = rng.integers(1, env.size - 1, (TREES, 2))
    dirs = rng.integers(0, 4, TREES)
    shape = (MG_OLOP["episodes"], MG_OLOP["horizon"], TREES)
    actions, drops = rng.integers(0, 3, shape), rng.random(shape).astype(np.float32)

    def states(device, n):
        return MiniGridState(torch.tensor(pos[:n], device=device),
                             torch.tensor(dirs[:n], device=device),
                             torch.zeros((n, 1), dtype=torch.bool, device=device),
                             torch.zeros(n, dtype=torch.int64, device=device))

    def draws(device, n):
        return dict(random_actions=torch.tensor(actions[:, :, :n], device=device),
                    env_noise=torch.tensor(drops[:, :, :n], device=device))

    return env, env.default_params(dev), states, draws


def minigrid_kl_calls(dev) -> list:
    """``[((out, sum, count, nodes, threshold), kwargs), ...]``: the inputs of
    the ``kl_bound_indexed_`` launches of episodes ``MG_RECORDED`` of one
    4096-tree KL-OLOP plan on MiniGrid, as the planner passed them."""
    from rl_agents_torch.agents.tree_search import olop

    env, params, states, draws = minigrid_case(dev)
    calls, seen, inner = [], [0], olop.kl_bound_indexed_

    def recording(out, _sum, count, nodes, threshold, **kwargs):
        if seen[0] in MG_RECORDED:
            calls.append(((out.clone(), _sum.clone(), count.clone(), nodes.clone(),
                           threshold.clone()), kwargs))
        seen[0] += 1
        return inner(out, _sum, count, nodes, threshold, **kwargs)

    olop.kl_bound_indexed_ = recording
    try:
        olop.olop_plan(env, params, states(dev, TREES), device=dev, **draws(dev, TREES),
                       **MG_OLOP)
    finally:
        olop.kl_bound_indexed_ = inner
    expect(seen[0] == MG_OLOP["episodes"], f"a MiniGrid plan made {seen[0]} indexed KL calls")
    return calls


def slice9_env(path: Path, steps: int = SLICE9_AGENT_STEPS) -> dict:
    """An env config of the corpus, its episodes cut to ``steps``."""
    return dict(json.loads(path.read_text()), max_episode_steps=steps)


def zero_kl_agent(dev, name: str, env_config, agent_config) -> dict:
    """A corpus agent that launches no KL kernel, one episode on the card."""
    from rl_agents_torch.factory import load_agent, load_environment

    env = load_environment(env_config, device=dev)
    return timed_agent_episode(dev, name, env, load_agent(agent_config, env, device=dev))


def check_minigrid_paths(dev) -> dict:
    """KL-OLOP on ``MiniGrid-Empty-16x16-v0`` at ``kl-olop.json``'s 55 x 9, 4096
    trees, one ``kl_bound_indexed_`` launch per episode, one plan timed and
    its first 64 trees held against the CPU plan under the same draws, a
    5-episode plan profiled; then
    ``kl-olop.json`` on ``empty.json`` and ``uct.json`` on
    ``collect_stochastic.json``, 3 steps each."""
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch

    env, params, states, draws = minigrid_case(dev)
    episodes, horizon = MG_OLOP["episodes"], MG_OLOP["horizon"]
    states0, noise = states(dev, TREES), draws(dev, TREES)
    plan = lambda: olop_plan_batch(env, params, states0, device=dev, **noise, **MG_OLOP)
    reset_launches()
    outs = []
    times = timed_plans(lambda: outs.append(plan()), 1)  # the kernels are warm from phase 14
    launches = read_launches()
    got = plan_fields(*outs[0])
    want = plan_fields(*olop_plan_batch(env, env.default_params(CPU), states(CPU, CPU_SUBSET),
                                        device=CPU, **draws(CPU, CPU_SUBSET), **MG_OLOP))
    same_on_cpu("olop_plan_batch on MiniGrid", got, want,
                ("actions", "lengths", "parent", "count", "done"), ("value_upper", "mu_ucb"),
                CPU_SUBSET)
    expect(got["done"].any() and np.isfinite(got["value_upper"]).all(),
           "MiniGrid plan: no path reached the goal, or a bound is not finite")
    expect_launches("KL-OLOP on MiniGrid, 1 plan", launches, 0, episodes)
    ms = report_plans(f"olop_plan_batch on MiniGrid-Empty-16x16 B={TREES} episodes={episodes} "
                      f"horizon={horizon}", times, TREES * episodes * horizon, "env-steps")
    # a plan of MG_PROFILED episodes: reading a trace takes time in proportion
    # to its kernels (the wrapper's counter above holds the launches)
    short = dict(MG_OLOP, episodes=MG_PROFILED)
    short_draws = {k: v[:MG_PROFILED] for k, v in noise.items()}
    prof = profile_plan(lambda: olop_plan_batch(env, params, states0, device=dev, **short_draws,
                                                **short), host_events=False)
    result = {"olop_minigrid_batch_plans": {"launches": launches, "ms": ms,
                                            "kernels_per_episode": prof["kernels"] / MG_PROFILED,
                                            "busy_share": prof["busy_share"]}}
    result["kl_olop_minigrid_agent"] = {"launches": check_agent_path(
        dev, "OLOPAgent (GridWorld/agents/kl-olop.json)", slice9_env(GRIDWORLD / "empty.json"),
        GRIDWORLD / "agents" / "kl-olop.json", 0, episodes)}
    result["uct_minigrid_agent"] = zero_kl_agent(
        dev, "MCTSAgent (GridWorld/agents/uct.json) on collect_stochastic.json",
        slice9_env(GRIDWORLD / "collect_stochastic.json"), GRIDWORLD / "agents" / "uct.json")
    return result


def check_grid_and_dynamics_paths(dev) -> dict:
    """MDP-GapE on ``DummyEnv/gridenv_stoch.json`` at ``mdp-gape.json``'s 35 x
    5, 4096 trees, one ``kl_bounds_pair_`` launch per episode,
    the first 64 trees against the CPU plan under the same draws (the grid's
    drop uniforms injected); then ``mdp-gape.json`` on the grid and
    ``kl-olop.json`` and ``brue.json`` on ``dynamics.json``, 3 steps each."""
    from rl_agents_torch.agents.tree_search.batch import mdp_gape_plan_batch
    from rl_agents_torch.envs.gridenv import GridState, make_grid
    from rl_agents_torch.utils.noise import gumbel, uniform

    grid = json.loads((DUMMY / "gridenv_stoch.json").read_text())
    env = make_grid(grid, device=CPU).functional
    params = env.default_params(dev)
    steps = (GRID_GAPE["episodes"] + 1, GRID_GAPE["horizon"], TREES)
    g = torch.Generator(device=dev).manual_seed(13)
    noise, env_noise = gumbel(steps + (4,), g, dev), uniform(steps, g, dev)
    start = np.random.default_rng(9).integers(-5, 6, (TREES, 2)).astype(np.float32)

    def states(device, n):
        return GridState(torch.tensor(start[:n], device=device),
                         torch.zeros(n, dtype=torch.int64, device=device))

    def fields(best, used, tree):
        return dict(tree_fields(best, tree), used=used.cpu().numpy())

    states0 = states(dev, TREES)
    plan = lambda: mdp_gape_plan_batch(env, params, states0, noise=noise, env_noise=env_noise,
                                       device=dev, **GRID_GAPE)
    reset_launches()
    reset_newton()
    outs = []
    times = timed_plans(lambda: outs.append(plan()), 1)  # the kernels are warm from phase 8
    launches = read_launches()
    newton = newton_line()
    got = fields(*outs[0])
    want = fields(*mdp_gape_plan_batch(env, env.default_params(CPU), states(CPU, CPU_SUBSET),
                                       noise=noise[:, :, :CPU_SUBSET].cpu(),
                                       env_noise=env_noise[:, :, :CPU_SUBSET].cpu(), device=CPU,
                                       **GRID_GAPE))
    same_on_cpu("mdp_gape_plan_batch on gridenv_stoch", got, want,
                ("actions", "used", "d_count", "d_children", "c_count", "c_children",
                 "c_n_children", "c_child_keys"),
                ("d_mu_ucb", "d_mu_lcb", "d_value_upper", "d_value_lower"), CPU_SUBSET)
    expect_launches("MDP-GapE on gridenv_stoch, 1 plan", launches, 0, 0, GRID_GAPE_KL_LAUNCHES)
    ms = report_plans(f"mdp_gape_plan_batch on gridenv_stoch B={TREES} "
                      f"episodes={GRID_GAPE['episodes']}+1 horizon={GRID_GAPE['horizon']}",
                      times, TREES * steps[0] * steps[1], "env-steps")
    print(f"  {newton}")
    result = {"mdp_gape_grid_batch_plans": {"launches": launches, "ms": ms}}
    result["mdp_gape_grid_agent"] = {"launches": check_agent_path(
        dev, "MDPGapEAgent (DummyEnv/agents/mdp-gape.json) on gridenv_stoch.json",
        slice9_env(DUMMY / "gridenv_stoch.json"), DUMMY / "agents" / "mdp-gape.json", 0, 0,
        kl_bounds_pair_per_plan=GRID_GAPE_KL_LAUNCHES)}
    result["kl_olop_dynamics_agent"] = {"launches": check_agent_path(
        dev, "OLOPAgent (DummyEnv/agents/kl-olop.json) on dynamics.json",
        slice9_env(DUMMY / "dynamics.json"), DUMMY / "agents" / "kl-olop.json", 0,
        DUMMY_OLOP_EPISODES)}
    result["brue_dynamics_agent"] = zero_kl_agent(
        dev, "BRUEAgent (DummyEnv/agents/brue.json) on dynamics.json",
        slice9_env(DUMMY / "dynamics.json"), DUMMY / "agents" / "brue.json")
    return result


def check_classic_and_parking_paths(dev) -> dict:
    """``MountainCarEnv/MCTSAgent.json``, ``Pendulum/OLOPAgent.json`` (one
    ``kl_bound_indexed_`` launch per planning episode), ``Pendulum/cem.json``
    and ``ParkingEnv/cem.json``, 3 steps each on their corpus envs."""
    result = {"mcts_mountaincar_agent": zero_kl_agent(
        dev, "MCTSAgent (MountainCarEnv/MCTSAgent.json)",
        slice9_env(CONFIGS / "MountainCarEnv" / "env.json"),
        CONFIGS / "MountainCarEnv" / "MCTSAgent.json")}
    pendulum = slice9_env(CONFIGS / "Pendulum" / "env.json")
    result["olop_pendulum_agent"] = {"launches": check_agent_path(
        dev, "OLOPAgent (Pendulum/OLOPAgent.json)", pendulum,
        CONFIGS / "Pendulum" / "OLOPAgent.json", 0, PENDULUM_OLOP_EPISODES)}
    result["cem_pendulum_agent"] = zero_kl_agent(dev, "CEMAgent (Pendulum/cem.json)", pendulum,
                                                 CONFIGS / "Pendulum" / "cem.json")
    result["cem_parking_agent"] = zero_kl_agent(
        dev, "CEMAgent (ParkingEnv/cem.json)", slice9_env(CONFIGS / "ParkingEnv" / "env.json"),
        CONFIGS / "ParkingEnv" / "cem.json")
    return result


def lmi_step_syncs(dev) -> int:
    """Host synchronisations of one step of the LMI descent on the card, as
    ``torch.cuda.set_sync_debug_mode`` reports them: a CUDA graph can hold a
    chunk of steps only if there are none."""
    import warnings

    from rl_agents_torch.agents.control import extended_matrices
    from rl_agents_torch.utils import lmi

    matrix, constraints, theta0 = lmi.interval_lmi_problem(*extended_matrices(**LMI_STABLE),
                                                           True, device=dev)
    affine = lmi.affine_matrix(matrix, theta0)
    x = lmi.flatten(affine, theta0)
    lmi.penalty_and_grad(affine, constraints, x, 1e-2, 1e-3, 1e-6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lmi.penalty_and_grad(affine, constraints, x, 1e-2, 1e-3, 1e-6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    for w in syncs[:3]:
        print(f"  sync: {str(w.message)[:120]}")
    return len(syncs)


def check_robust_control_paths(dev) -> dict:
    """The interval predictor over 4096 interval states for 40 steps on the
    card against the CPU; ``ObstacleEnv/RobustEPCAgent.json`` on
    ``ObstacleEnv/env.json`` for 3 steps, each action against a CPU agent's;
    ``ConstrainedEPCAgent`` at tests/agents/test_robust.py's configuration,
    3 plans with their synthesis timed; ``LaneKeepingEnv/agents/linear.json``
    for 3 steps; the LMI solves of tests/agents/test_lmi.py's systems, their
    verdicts and times on the card against the CPU's, and the host
    synchronisations of one descent step."""
    from rl_agents_torch.agents.control import extended_matrices
    from rl_agents_torch.agents.robust.constrained_epc import ConstrainedEPCAgent
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.robust.interval import lpv_step, make_lpv
    from rl_agents_torch.utils import lmi

    rng = np.random.default_rng(21)
    x0 = rng.normal(size=(TREES, 2)) * 0.5
    controls = rng.choice([-1.0, 1.0], (LPV_STEPS, TREES, 1)).astype(np.float32)

    def trajectory(device):
        lpv = make_lpv(LPV_SYSTEM["a0"], LPV_SYSTEM["da"], x0, LPV_SYSTEM["b"], LPV_SYSTEM["d"],
                       LPV_SYSTEM["omega"], device=device)
        u = torch.tensor(controls, device=device)
        started = time.perf_counter()
        for t in range(LPV_STEPS):
            lpv = lpv_step(lpv, u[t], 0.1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return lpv, (time.perf_counter() - started) * 1e3 / LPV_STEPS

    trajectory(dev)  # warm-up
    reset_launches()
    got, card_ms = trajectory(dev)
    want, cpu_ms = trajectory(CPU)
    scale = max(1.0, float(want.x_hi.abs().max()), float(want.x_lo.abs().max()))
    err = max(float((got.x_lo.cpu() - want.x_lo).abs().max()),
              float((got.x_hi.cpu() - want.x_hi).abs().max())) / scale
    expect(err <= LPV_TOLERANCE and bool((got.x_lo <= got.x_hi).all()),
           f"lpv_step on the card: {err!r} from the CPU's (relative)")
    print(f"lpv_step {TREES} interval states x {LPV_STEPS} steps: {card_ms!r} ms a step on the "
          f"card, {cpu_ms!r} on the CPU, max|card - CPU| / scale = {err!r}")
    result = {"lpv_interval_states": {"launches": read_launches(), "ms_per_step": card_ms,
                                      "cpu_ms_per_step": cpu_ms, "max_rel_err": err}}

    env_file = CONFIGS / "ObstacleEnv" / "env.json"
    agent_file = CONFIGS / "ObstacleEnv" / "RobustEPCAgent.json"
    handles = [load_environment(slice9_env(env_file), device=d) for d in (dev, CPU)]
    agents = [load_agent(agent_file, h, device=d) for h, d in zip(handles, (dev, CPU))]
    observations = [h.reset(seed=0)[0] for h in handles]
    reset_launches()
    seconds = []
    for _ in range(SLICE9_AGENT_STEPS):
        started = time.perf_counter()
        action = agents[0].act(observations[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - started)
        expect(action == agents[1].act(observations[1]),
               "RobustEPCAgent: the card's action differs from the CPU agent's")
        next_observations = []
        for h, a, o in zip(handles, agents, observations):
            out = h.step(action)
            a.record(o, action, out[1], out[0], out[2], out[4])
            next_observations.append(out[0])
        observations = next_observations
        expect(np.array_equal(agents[0].polytope()[0], agents[1].polytope()[0]),
               "RobustEPCAgent: the polytopes differ")
    launches = read_launches()
    expect_launches("RobustEPCAgent", launches, 0, 0)
    theta = agents[0].ellipsoids[-1][0]
    print(f"RobustEPCAgent (ObstacleEnv/RobustEPCAgent.json): {SLICE9_AGENT_STEPS} steps, "
          f"{statistics.median(seconds)!r} s per act(), actions equal to the CPU agent's, "
          f"theta estimate {theta.tolist()}, launches {launches}")
    result["robust_epc_obstacle_agent"] = {"launches": launches,
                                           "s_per_act": statistics.median(seconds)}

    linear = load_environment({"id": "linear-system", "max_episode_steps": 30}, device=dev)
    agent = ConstrainedEPCAgent(linear, copy.deepcopy(EPC_TEST), device=dev)
    obs = linear.reset(seed=0)[0]
    reset_launches()
    synthesis = []
    for _ in range(SLICE9_AGENT_STEPS):
        started = time.perf_counter()
        agent.update_model_and_controller()
        synthesis.append(time.perf_counter() - started)
        control = agent.plan(obs)[0]
        obs = linear.step(1 if np.ravel(control)[0] < 0 else 0)[0]
    launches = read_launches()
    expect_launches("ConstrainedEPCAgent", launches, 0, 0)
    expect(agent.feedback.K0 is not None and np.isfinite(control).all(),
           "ConstrainedEPCAgent: no gain or no control")
    print(f"ConstrainedEPCAgent (tests/agents/test_robust.py:133-156): {SLICE9_AGENT_STEPS} "
          f"plans, synthesis {statistics.median(synthesis)!r} s (pole placement: the config "
          f"leaves ensure_stability false, so no LMI), K0 {np.round(agent.feedback.K0, 4).tolist()}")
    result["constrained_epc_agent"] = {"launches": launches,
                                       "s_synthesis": statistics.median(synthesis)}
    result["linear_lane_keeping_agent"] = zero_kl_agent(
        dev, "LinearFeedbackAgent (LaneKeepingEnv/agents/linear.json)",
        slice9_env(CONFIGS / "LaneKeepingEnv" / "env.json"),
        CONFIGS / "LaneKeepingEnv" / "agents" / "linear.json")

    reset_launches()
    solves = {}
    for label, system, synthesize, iters in LMI_CASES:
        verdicts, times_s, steps = [], [], []
        for device in (dev, CPU):
            started = time.perf_counter()
            sol = lmi.solve_interval_lmi(*extended_matrices(**system),
                                         synthesize_control=synthesize, iters=iters,
                                         device=device)
            times_s.append(time.perf_counter() - started)
            verdicts.append(sol is not None)
            steps.append(lmi.solve_spectral_feasibility.steps)
        expect(verdicts[0] == verdicts[1] == (system is LMI_STABLE),
               f"LMI {label}: verdicts {verdicts} on the card and the CPU")
        print(f"LMI {label}: certified {verdicts[0]} after {steps[0]} steps on the card "
              f"({times_s[0]!r} s, {times_s[0] / steps[0] * 1e3!r} ms a step) and {steps[1]} on "
              f"the CPU ({times_s[1]!r} s)")
        solves[label] = {"certified": verdicts[0], "steps": steps[0], "s": times_s[0],
                         "cpu_steps": steps[1], "cpu_s": times_s[1]}
    syncs = lmi_step_syncs(dev)
    print(f"one LMI descent step synchronises with the host {syncs} times: a CUDA graph "
          f"{'cannot' if syncs else 'can'} hold a chunk")
    launches = read_launches()
    expect_launches("LMI solves", launches, 0, 0)
    result["lmi_solves"] = {"launches": launches, "solves": solves, "syncs_per_step": syncs}
    return result


# ---------------------------------------------------------------------------
# Slice 10: the sharded learner and planner batch on NCCL, serving,
# checkpoints and profiling
# ---------------------------------------------------------------------------

# __graft_entry__.py::dryrun_multichip's sizes: S shards of E envs, rings of
# C, B rows a shard; CartPole with a (64, 64) MLP for 12 steps, the
# EgoAttention flagship on highway (6 vehicles, 3 lanes) for 8
SHARDED = dict(num_shards=4, envs_per_shard=2, capacity=64, batch_size=4, learning_starts=8)
SHARDED_STEPS = {"cartpole": 12, "highway": 8}
FLAGSHIP = dict(out=5, embedding_layers=(16,), others_embedding_layers=(16,),
                output_layers=(16,), feature_size=16, heads=2)
SERVED_BATCHES = (1, 64, 4096)
SERVING_Q_TOLERANCE = 1e-6
# highway's rewards go through transcendentals that the card and the CPU
# round apart by ulps; CartPole's are held equal
SHARDED_REWARD_TOLERANCE = {"cartpole": 0.0, "highway": 1e-6}


def sharded_case(name: str):
    """(env, model, injected draws on the CPU) of one sharded learner case;
    the draws come from a seeded CPU generator, so the card and the CPU run
    the same segment."""
    from rl_agents_torch.envs.cartpole import CartPoleEnv
    from rl_agents_torch.envs.highway import HighwayEnv
    from rl_agents_torch.models.zoo import EgoAttentionNetwork, MultiLayerPerceptron
    from rl_agents_torch.parallel.actor_learner import SegmentDraws

    S, E, B = SHARDED["num_shards"], SHARDED["envs_per_shard"], SHARDED["batch_size"]
    K = SHARDED_STEPS[name]
    g = torch.Generator().manual_seed(10)
    if name == "cartpole":
        env, model = CartPoleEnv(max_episode_steps=50), MultiLayerPerceptron(4, (64, 64), out=2)
        reset0 = torch.rand((S, E, 4), generator=g) * 0.1 - 0.05
        reset = torch.rand((K, S, E, 4), generator=g) * 0.1 - 0.05
    else:
        env = HighwayEnv(vehicles=6, lanes=3, max_episode_steps=20)
        model = EgoAttentionNetwork(env.observation_space.shape[-1], **FLAGSHIP)

        def highway_noise(*lead):
            shape = lead + (env.vehicles,)
            return (torch.rand(shape, generator=g),
                    torch.randint(0, env.lanes, shape, generator=g),
                    torch.rand(shape, generator=g))
        reset0, reset = highway_noise(S, E), highway_noise(K, S, E)
    draws = SegmentDraws(explore=torch.rand((K, S, E), generator=g),
                         random_actions=torch.randint(0, env.action_space.n, (K, S, E),
                                                      generator=g),
                         reset=reset, sample=torch.rand((K, S, B), generator=g))
    return env, model, reset0, draws


def to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(to_device(x, device) for x in tree)) if hasattr(tree, "_fields") \
        else type(tree)(to_device(x, device) for x in tree)


def nccl_kernels(run) -> dict:
    """A profile of ``run``: its ``all_reduce`` calls, the device kernels
    whose name holds ``nccl``, and all its device kernels."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0 or e.count]
    return {"all_reduce_calls": len(calls),
            "nccl_kernels": sum(e.count for e in events if "nccl" in e.key.lower()),
            "device_kernels": sum(e.count for e in events
                                  if e.device_type == torch.autograd.DeviceType.CUDA)}


def check_distributed(dev) -> dict:
    """``make_sharded_actor_learner`` on a one-rank NCCL group at
    ``dryrun_multichip``'s sizes (4 shards, tp off: one rank has no tp axis),
    each case held against the same segment on the CPU under the same
    injected draws; returns the flagship's state and generator for phase 39."""
    import torch.distributed as dist

    from rl_agents_torch.models.optimizers import optimizer_factory
    from rl_agents_torch.parallel.actor_learner import make_sharded_actor_learner
    from rl_agents_torch.parallel.distributed import make_pod_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    mesh = make_pod_mesh(axes=("host", "dp"), hosts=1)
    expect(mesh.device_type == "cuda" and dist.get_backend() == "nccl",
           "the one-rank group is not NCCL on the card")
    result, states = {}, {}
    reset_launches()
    for name in ("cartpole", "highway"):
        env, model, reset0, draws = sharded_case(name)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        runs = {}
        for label, device, group_mesh in (("card", dev, mesh), ("cpu", CPU, None)):
            init_fn, segment_fn, shardings_fn = make_sharded_actor_learner(
                env, copy.deepcopy(model), optimizer_factory("ADAM", lr=5e-4), group_mesh,
                device=device, **SHARDED)
            state = init_fn(torch.Generator(device=device).manual_seed(0), params=params,
                            reset_noise=to_device(reset0, device))
            device_draws = to_device(draws, device)
            started = time.time()
            _, reward = segment_fn(state, steps=SHARDED_STEPS[name], draws=device_draws)
            if device.type == "cuda":
                torch.cuda.synchronize()
            runs[label] = (state, float(reward), time.time() - started, segment_fn, shardings_fn)
        card, cpu = runs["card"][0], runs["cpu"][0]
        for field in ("action", "terminal"):
            expect(torch.equal(getattr(card.buffer, field).cpu(), getattr(cpu.buffer, field)),
                   f"sharded learner ({name}): the ring's {field} differs from the CPU's")
        reward_diff = float((card.buffer.reward.cpu() - cpu.buffer.reward).abs().max())
        expect(reward_diff <= SHARDED_REWARD_TOLERANCE[name],
               f"sharded learner ({name}): rewards {reward_diff!r} from the CPU's")
        counters = [int(getattr(s, f)) for s in (card, cpu)
                    for f in ("position", "size", "time", "completed_count")]
        expect(counters[:4] == counters[4:] and int(card.opt_state["count"]) > 0,
               f"sharded learner ({name}): counters {counters} differ or no update ran")
        worst = max(float((card.params[k].cpu() - cpu.params[k]).abs().max())
                    for k in cpu.params)
        expect(worst <= MODEL_TOLERANCE, f"sharded learner ({name}): parameters {worst!r} "
                                         f"from the CPU's")
        segment_fn = runs["card"][3]
        steps = SHARDED_STEPS[name]
        started = time.time()  # a second segment, its draws from the rank's generator
        segment_fn(card, steps=steps)
        torch.cuda.synchronize()
        ms = (time.time() - started) / steps * 1e3
        profiled = nccl_kernels(lambda: segment_fn(card, steps=1, draws=first_step(
            to_device(draws, dev))))
        print(f"sharded learner, {name}, one-rank NCCL group, {SHARDED['num_shards']} shards x "
              f"{SHARDED['envs_per_shard']} envs: {steps} steps (first segment "
              f"{runs['card'][2] / steps * 1e3!r} ms a step), {int(card.opt_state['count'])} "
              f"updates; actions, terminals and counters equal to the CPU's, rewards within "
              f"{reward_diff!r}, parameters within {worst!r}; a second segment {ms!r} ms a step "
              f"(eager); one profiled step: {profiled}")
        result[name] = {"ms_per_step": ms, "param_err": worst, "reward_err": reward_diff,
                        **profiled}
        states[name] = (card, runs["card"][3], runs["card"][4], to_device(draws, dev))
    launches = read_launches()
    expect_launches("sharded learner", launches, 0, 0)
    return {"launches": launches, "cases": result, "states": states}


def first_step(draws):
    """The first step of a segment's draws, as a one-step segment."""
    from rl_agents_torch.parallel.actor_learner import SegmentDraws

    def first(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x[:1]
        return type(x)(first(v) for v in x)
    return SegmentDraws(*(first(x) for x in draws))


def check_sharded_planner_batch(dev, unsharded_actions) -> dict:
    """``sharded_planner_batch`` over KL-OLOP on CartPole at phase 4's 4096
    trees x 23 x 8 on the one-rank NCCL group: one ``kl_bound_indexed_``
    launch per episode, actions equal to phase 4's unsharded plan."""
    from rl_agents_torch.agents.tree_search.batch import olop_plan_batch
    from rl_agents_torch.parallel.distributed import make_pod_mesh
    from rl_agents_torch.parallel.mesh import sharded_planner_batch

    env, params, states = cartpole_case(dev)
    kw = dict(num_actions=2, episodes=EPISODES, horizon=HORIZON, gamma=GAMMA, threshold_coeff=4.0)
    mesh = make_pod_mesh(axes=("host", "dp"), hosts=1)
    states0 = states(dev, TREES)
    outs = []
    plan = lambda: outs.append(sharded_planner_batch(
        mesh, lambda p, s, n: olop_plan_batch(env, p, s, device=dev, **kw)[:2], params, states0))
    plan()  # warm-up
    outs.clear()
    reset_launches()
    times = timed_plans(plan, count=1)
    launches = read_launches()
    expect_launches("sharded planner batch", launches, 0, EPISODES)
    actions = outs[0][0].cpu().numpy()
    expect(np.array_equal(actions, unsharded_actions),
           "sharded planner batch: actions differ from phase 4's unsharded plan")
    report_plans(f"sharded_planner_batch (olop_plan_batch) B={TREES} episodes={EPISODES} "
                 f"horizon={HORIZON}, one-rank NCCL group", times,
                 TREES * EPISODES * HORIZON, "env-steps")
    unsharded = timed_plans(lambda: olop_plan_batch(env, params, states0, device=dev, **kw), 1)
    print(f"  {launches['kl_bound_indexed_']} kl_bound_indexed_ launches; actions equal to "
          f"phase 4's unsharded plan; the unsharded plan here: {unsharded[0]!r} ms")
    return {"launches": launches, "ms": times[0], "unsharded_ms": unsharded[0]}


def check_serving(dev, agent, handle) -> dict:
    """The greedy policy of phase 17's trained highway DQN exported on the
    card, loaded with ``load_policy`` and served at batches of 1, 64 and 4096
    highway observations: actions equal the agent's greedy actions, Q within
    ``SERVING_Q_TOLERANCE``."""
    from rl_agents_torch.agents.dqn.agent import q_values
    from rl_agents_torch.serving import load_policy, save_policy

    path = REPO / "out" / "chip_smoke" / "serving" / "ego_attention.pt2"
    reset_launches()
    started = time.time()
    save_policy(agent, path)
    export_s = time.time() - started
    policy = load_policy(path)
    functional = handle.functional
    _, obs = functional.reset(handle.params, torch.Generator(device=dev).manual_seed(11),
                              max(SERVED_BATCHES))
    served = {}
    for batch in SERVED_BATCHES:
        x = obs[:batch].float()
        actions, q = policy(x)
        with torch.no_grad():
            want = q_values(agent.model, agent.train_state.params, x)
        err = float((q - want).abs().max())
        expect(torch.equal(actions, want.argmax(dim=1)) and err <= SERVING_Q_TOLERANCE,
               f"served policy at batch {batch}: actions differ or Q {err!r} from the agent's")
        served[batch] = {"ms": cuda_ms(lambda: policy(x), 20), "q_err": err}
    print(f"served policy (ego_attention.json, trained in phase 17): exported in {export_s!r} s; "
          + ", ".join(f"batch {b}: {r['ms']!r} ms, Q within {r['q_err']!r}"
                      for b, r in served.items()) + "; actions equal to the agent's")
    return {"launches": read_launches(), "export_s": export_s, "served": served}


def check_checkpoint_and_profiling(dev, states) -> dict:
    """A ``save_pytree`` / ``load_pytree`` round trip of phase 36's flagship
    state on the card, bit-equal; a ``trace()`` of one CartPole segment, its
    Chrome trace written; ``device_memory_stats()``."""
    from rl_agents_torch.trainer.checkpoint import load_pytree, save_pytree
    from rl_agents_torch.trainer.profiling import device_memory_stats, trace

    directory = REPO / "out" / "chip_smoke" / "slice10"
    state, _, shardings_fn, _ = states["highway"]
    reset_launches()
    started = time.time()
    save_pytree(directory / "flagship", state, shardings_fn(state))
    restored = load_pytree(directory / "flagship", template=state)
    seconds = time.time() - started

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, torch.Generator):
            return [tree.get_state()]
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [x for v in tree for x in leaves(v)]
    pairs = list(zip(leaves(state), leaves(restored)))
    expect(all(torch.equal(a, b) and a.device == b.device for a, b in pairs),
           "checkpoint round trip: a leaf differs or moved")
    print(f"save_pytree / load_pytree of the flagship's sharded state: {len(pairs)} leaves "
          f"bit-equal on {restored.obs.device}, {seconds!r} s")
    card, segment_fn, _, draws = states["cartpole"]
    with trace(directory / "trace"):
        segment_fn(card, steps=1, draws=first_step(draws))
    size = (directory / "trace" / "trace.json").stat().st_size
    expect(size > 0, "trace(): no trace written")
    print(f"trace() of one sharded CartPole step: {size} bytes of Chrome trace")
    stats = device_memory_stats()
    print(f"device_memory_stats(): {json.dumps(stats)}")
    expect(stats and all(s["bytes_limit"] > 0 for s in stats.values()),
           "device_memory_stats(): no card")
    return {"launches": read_launches(), "checkpoint_s": seconds, "trace_bytes": size,
            "memory": stats}


# ---------------------------------------------------------------------------
# Slice 11: MCTS on a stochastic env under injected draws, the env base's
# rollouts, and the display path. No new kernel: the display path's KL-OLOP
# agent launches the indexed KL kernel
# ---------------------------------------------------------------------------

# Whether this host can draw: a probe of the H100 host found neither
# matplotlib nor pygame installed, so phase 42 checks what each frame and
# figure draws as data, and the drawing itself is tested on the CPU
# (tests/test_torch_graphics.py, tests/test_torch_pygame_viewer.py)
CHIP_HAS_DRAWING = False
# floats of a step on the card against the CPU's, relative to max(1, |value|):
# the card's sin and cos differ from the CPU's by an ulp, 1.9e-06 at 16
ROLLOUT_TOLERANCE = 1e-6
CARTPOLE_ROLLOUT = (TREES, 200)  # trees x steps
HIGHWAY_ROLLOUT = (512, 20)
DISPLAY_STEPS = 3


def check_stochastic_mcts_paths(dev) -> dict:
    """MCTS on the stochastic garnet of ``env_garnet.json`` (two next states
    an action), every draw injected: ``mcts_plan_batch_fused`` at 4096 trees
    x 23 x 8, and ``mcts_prior_plan`` under a per-state table ``[S, A]`` and
    under a root vector ``[A]`` (the whole vector at a state below A, zeros
    at A or above); one timed plan each, the first 64 trees against the CPU
    plan under the same draws (actions, counts and children equal, values
    within 1e-5)."""
    from rl_agents_torch.agents.tree_search.mcts_fused import mcts_plan_batch_fused
    from rl_agents_torch.agents.tree_search.mcts_with_prior import mcts_prior_plan, tabular_prior
    from rl_agents_torch.envs.base import params_to
    from rl_agents_torch.utils.noise import gumbel

    env, params, states = garnet_case(dev, 2)
    on = {dev: params, CPU: params_to(params, CPU)}
    A, K, S = env.num_actions, 2, env.num_states
    E, H = EPISODES, HORIZON
    kw = dict(num_actions=A, episodes=E, horizon=H, gamma=GAMMA, temperature=MCTS_TEMPERATURE)
    probs = torch.ones(A) / A
    g = torch.Generator().manual_seed(11)
    noise, env_noise = gumbel((E, H, 2, A, TREES), g, CPU), gumbel((E, H, TREES, K), g, CPU)
    prior_noise = gumbel((2, E, H, TREES, A), g, CPU)
    prior_env_noise = gumbel((2, E, H, TREES, K), g, CPU)
    rows = torch.softmax(torch.randn((S, A), generator=g) / 0.5, dim=-1)
    result = {}

    def fused(device, n):
        return mcts_plan_batch_fused(env, on[device], states(device, n), None, probs, probs,
                                     noise=noise[..., :n], env_noise=env_noise[:, :, :n],
                                     device=device, **kw)

    def prior(table):
        def plan(device, n):
            s0 = states(device, n)
            return mcts_prior_plan(env, on[device], s0, env.observe(on[device], s0), None,
                                   table.to(device), tabular_prior,
                                   noise=tuple(x[:, :, :n] for x in prior_noise),
                                   env_noise=tuple(x[:, :, :n] for x in prior_env_noise),
                                   device=device, **kw)
        return plan

    starts = states(CPU, CPU_SUBSET).s.numpy()
    for name, plan, close in (("mcts_fused_garnet", fused, ("value",)),
                              ("mcts_prior_table_garnet", prior(rows), ("value", "prior")),
                              ("mcts_prior_root_vector_garnet", prior(rows[5]),
                               ("value", "prior"))):
        outs = []
        reset_launches()
        times = timed_plans(lambda: outs.append(plan(dev, TREES)), 1)
        launches = read_launches()
        expect_launches(name, launches, 0, 0)
        ms = report_plans(f"{name} B={TREES} episodes={E} horizon={H}, env draws injected",
                          times, TREES * E * H, "env-steps")
        got = plan_fields(*outs[0])
        expect((got["count"][:, 0] == E).all() and np.isfinite(got["value"]).all(),
               f"{name}: invalid root counts or values")
        want = plan_fields(*plan(CPU, CPU_SUBSET))
        same_on_cpu(name, got, want, ("actions", "lengths", "count", "parent", "children"),
                    close)
        if name == "mcts_prior_root_vector_garnet":
            # the root's expansion: the vector below A, zeros at A or above
            root = got["prior"][:CPU_SUBSET, 1:1 + A]
            below = starts < A
            expect(np.array_equal(root[below], np.broadcast_to(rows[5].numpy(),
                                                               root[below].shape))
                   and (root[~below] == 0).all() and below.any() and (~below).any(),
                   f"{name}: the root priors are not the vector below A and zeros above")
            print(f"  root priors: the vector at {int(below.sum())} start states below A = {A}, "
                  f"zeros at {int((~below).sum())}")
        result[name] = {"launches": launches, "ms": ms}
    return result


def rollout_leaves(out) -> dict:
    """The tensors of a stacked ``StepOut`` by name."""
    leaves = {f"state.{k}": v for k, v in out.state._asdict().items()}
    obs = out.obs if isinstance(out.obs, tuple) else (out.obs,)
    leaves.update({f"obs.{i}": v for i, v in enumerate(obs)})
    leaves.update(reward=out.reward, terminated=out.terminated, truncated=out.truncated)
    leaves.update({f"info.{k}": v for k, v in out.info.items() if isinstance(v, torch.Tensor)})
    return leaves


def same_rollout(name: str, got, want, step_again):
    """The card's rollout ``got`` against the CPU's ``want``: integer and
    boolean leaves equal at every step, and each step's floats within
    ROLLOUT_TOLERANCE (relative to max(1, |value|)) of the CPU's when the
    card steps again from the CPU's
    state of the step before (``step_again(previous states [T, B])``, one
    batch of T x B rows). Along a whole rollout the card's ``sin`` and
    ``cos`` differ from the CPU's by ulps, which a falling CartPole pole
    amplifies: that drift is printed, not held."""
    leaves = rollout_leaves(want)
    drift = {}
    for key, w in leaves.items():
        g = rollout_leaves(got)[key].cpu()
        if w.dtype.is_floating_point:
            drift[key] = float((g - w).abs().max())
        elif not torch.equal(g, w):
            raise AssertionError(f"{name}: {key} differs from the CPU rollout")
    again = rollout_leaves(step_again())
    errors = {}
    for key, w in leaves.items():
        if key == "reward" or key not in again:
            continue  # policy_rollout zeroes the rewards after an episode's end
        g = again[key].cpu().reshape(w.shape)
        if w.dtype.is_floating_point:
            errors[key] = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
        elif not torch.equal(g, w):
            raise AssertionError(f"{name}: {key} of a step from the CPU's state differs")
    worst = max(errors.values())
    expect(worst <= ROLLOUT_TOLERANCE,
           f"{name}: a step from the CPU's state differs from the CPU's by {errors}")
    print(f"{name}: integer and boolean fields equal to the CPU rollout at every step; each "
          f"step's floats within {worst!r} (relative) of the CPU's from the same state; along "
          f"the whole rollout the floats drift up to {max(drift.values())!r}")


def previous_states(start, stacked):
    """The state before each step of a stacked rollout, ``[T, B]`` rows
    flattened to one batch: the start, then each step's state but the last."""
    return type(start)(*(torch.cat([s0[None], s[:-1]]).flatten(0, 1)
                         for s0, s in zip(start, stacked)))


def check_rollouts(dev) -> dict:
    """``FunctionalEnv.rollout`` and ``policy_rollout`` on CartPole (4096 x
    200 steps) and on the uncut highway (512 x 20), the actions and the
    policy's Gumbel draws made once on the CPU: the card against the CPU
    (``same_rollout``)."""
    from rl_agents_torch.envs.base import params_to, policy_rollout
    from rl_agents_torch.utils.noise import gumbel

    cartpole_env, cartpole_params, cartpole_states = cartpole_case(dev)
    highway_env, highway_params, highway_states = highway_case(dev)
    cases = {
        "cartpole": (cartpole_env, lambda device: cartpole_env.default_params(device),
                     cartpole_states, CARTPOLE_ROLLOUT,
                     lambda obs: torch.stack([-10.0 * obs[:, 2], 10.0 * obs[:, 2]], dim=1)),
        "highway": (highway_env, highway_params, highway_states, HIGHWAY_ROLLOUT,
                    lambda obs: 3.0 * obs.reshape(obs.shape[0], -1)[:, :HW_ACTIONS]),
    }
    g = torch.Generator().manual_seed(12)
    result = {}
    for name, (env, params, states, (B, T), logits) in cases.items():
        A = env.action_space.n
        actions = torch.randint(0, A, (T, B), generator=g)
        draws = gumbel((T, B, A), g, CPU)
        policy = lambda obs, draw: (logits(obs) + draw.to(obs.device)).argmax(dim=1)
        runs = {
            f"rollout_{name}": lambda device: env.rollout(params(device), states(device, B),
                                                          actions.to(device)),
            f"policy_rollout_{name}": lambda device: policy_rollout(
                env, policy, params(device), states(device, B), T, policy_noise=draws),
        }
        for path, run in runs.items():
            outs = []
            reset_launches()
            times = timed_plans(lambda: outs.append(run(dev)), 1)
            launches = read_launches()
            expect_launches(path, launches, 0, 0)
            print(f"{path} {B} x {T} steps: {times[0]!r} ms, {B * T / (times[0] / 1e3)!r} "
                  f"env-steps/s")
            expect(bool(outs[0].done.any()), f"{path}: no episode ended in {T} steps")
            want = run(CPU)
            before = params_to(previous_states(states(CPU, B), want.state), dev)
            if path.startswith("policy"):
                taken = policy(env.observe(params(dev), before), draws.flatten(0, 1))
            else:
                taken = actions.flatten().to(dev)
            same_rollout(path, outs[0], want, lambda: env.step(params(dev), before, taken))
            result[path] = {"launches": launches, "ms": times[0]}
    return result


def cpu_drawn_resets(handle, seed: int):
    """Make the CartPole handle's resets draw their start states from a CPU
    generator seeded with ``seed``, so that the card and the CPU start from
    the same states."""
    functional = handle.functional

    def reset_noise(params, generator, batch=1):
        draw = torch.rand((batch, 4), generator=torch.Generator().manual_seed(seed))
        return (draw * 0.1 - 0.05).to(params.gravity.device)

    functional.reset_noise = reset_noise


def check_display_path(dev, dqn_agent, dqn_handle, bftq_agent, bftq_state) -> dict:
    """The display path: one ``Evaluation`` test episode of the KL-OLOP
    agent (``budget`` 184, 8 episodes a plan) on CartPole, 3 steps, with
    ``display_agent`` and ``display_rewards``; each step's frame data and
    tree 0's plotted edges and values, and the reward history, against the
    same episode on the CPU; phase 17's attention matrix and phase 23's BFTQ
    cloud and frontier against the CPU on the same weights."""
    from types import SimpleNamespace

    from rl_agents_torch.agents.tree_search.common import allocation
    from rl_agents_torch.factory import load_agent, load_environment
    from rl_agents_torch.graphics.agent_graphics import BFTQGraphics, DQNGraphics
    from rl_agents_torch.graphics.render import renderer_for
    from rl_agents_torch.graphics.tree_plot import TreePlot
    from rl_agents_torch.trainer.evaluation import Evaluation

    cartpole = json.loads((CONFIGS / "CartPoleEnv" / "env.json").read_text())
    cartpole["max_episode_steps"] = DISPLAY_STEPS
    per_plan = allocation(AGENT_CONFIG["budget"], GAMMA)[0]

    def episode(device):
        env = load_environment(dict(cartpole), device=device)
        cpu_drawn_resets(env, 4)
        agent = load_agent(dict(AGENT_CONFIG), env, device=device)
        drawn = {"frames": [], "edges": []}

        def record(episode, env_, agent_, transition, writer):
            drawn["frames"].append(renderer_for(env_).frame_data(env_))
            drawn["edges"].append(np.asarray(TreePlot(agent_.last_plan_data).edges()))

        evaluation = Evaluation(env, agent, directory=REPO / "out" / "chip_smoke" / "display",
                                num_episodes=1, training=False, sim_seed=0,
                                display_env=CHIP_HAS_DRAWING, display_agent=True,
                                display_rewards=True, step_callback_fn=record)
        reset_launches()
        started = time.time()
        evaluation.test()
        if device.type == "cuda":
            torch.cuda.synchronize()
        drawn["seconds"], drawn["launches"] = time.time() - started, read_launches()
        drawn["rewards"] = evaluation.reward_viewer.rewards
        if CHIP_HAS_DRAWING:
            expect(bool(list(evaluation.run_directory.glob("episode-0.gif"))),
                   "display path: no GIF was written")
        return drawn

    got = episode(dev)
    steps = len(got["frames"])
    expect(steps == DISPLAY_STEPS, f"display path: {steps} steps, expected {DISPLAY_STEPS}")
    expect_launches("display path (KL-OLOP agent)", got["launches"], 0, per_plan * steps)
    want = episode(CPU)
    expect(got["rewards"] == want["rewards"] == [float(steps)],
           f"display path: reward history {got['rewards']} against the CPU's {want['rewards']}")
    frame_err = max(abs(g[k] - w[k]) for g, w in zip(got["frames"], want["frames"]) for k in g)
    expect(frame_err <= ROLLOUT_TOLERANCE,
           f"display path: frame data differs from the CPU's by {frame_err!r}")
    for g, w in zip(got["edges"], want["edges"]):
        expect(g.shape == w.shape and g.shape[0] > 0,
               f"display path: tree edges {g.shape} against the CPU's {w.shape}")
    edge_err = max(float(np.abs(g - w).max()) for g, w in zip(got["edges"], want["edges"]))
    expect(edge_err <= KL_TOLERANCE, f"display path: tree edges differ by {edge_err!r}")
    print(f"display path: KL-OLOP (budget {AGENT_CONFIG['budget']}, {per_plan} episodes a plan) "
          f"on CartPole, {steps} steps with display_agent and display_rewards, "
          f"{got['seconds'] / steps!r} s a step, launches {got['launches']}; frame data within "
          f"{frame_err!r} of the CPU's, {[len(e) for e in got['edges']]} tree edges a step within "
          f"{edge_err!r}, reward history {got['rewards']} equal")
    if not CHIP_HAS_DRAWING:
        print("  this host has neither matplotlib nor pygame: the frames and figures are held "
              "as data here, and drawn in tests/test_torch_graphics.py and "
              "tests/test_torch_pygame_viewer.py on the CPU")

    obs = dqn_handle.reset(seed=0)[0]
    started = time.time()
    attention = DQNGraphics.attention_matrix(dqn_agent, obs)
    attention_s = time.time() - started
    cpu_dqn = SimpleNamespace(model=copy.deepcopy(dqn_agent.model).cpu(), device=CPU,
                              train_state=SimpleNamespace(params={
                                  k: v.cpu() for k, v in dqn_agent.train_state.params.items()}))
    attention_err = float(np.abs(attention - DQNGraphics.attention_matrix(cpu_dqn, obs)).max())
    expect(attention_err <= MODEL_TOLERANCE,
           f"attention matrix: card against CPU {attention_err!r}")
    print(f"attention matrix of phase 17's agent {attention.shape}: {attention_s!r} s, within "
          f"{attention_err!r} of the CPU's")

    # the network's cloud on the card against the CPU's; the frontier of the
    # card's cloud against the frontier of the same cloud on the CPU (a hull
    # over near-collinear points may keep or drop one of them when its
    # inputs move by an ulp, as phase 23's trained network shows)
    bftq = bftq_agent.bftq
    started = time.time()
    points = BFTQGraphics.frontier_points(bftq_agent, bftq_state)
    frontier_s = time.time() - started
    cpu_bftq = SimpleNamespace(bftq=SimpleNamespace(
        betas_for_discretisation=bftq.betas_for_discretisation.cpu(),
        network=copy.deepcopy(bftq.network).cpu(),
        params={k: v.cpu() for k, v in bftq.params.items()}))
    cpu_points = BFTQGraphics.frontier_points(cpu_bftq, bftq_state)
    cloud_err = max(float(np.abs(points[k] - cpu_points[k]).max()) for k in ("q", "qc", "qr"))
    expect(cloud_err <= BFTQ_TOLERANCE, f"BFTQ cloud: card against CPU {cloud_err!r}")
    same_cloud = BFTQGraphics.frontier_of(torch.tensor(points["q"]),
                                          bftq.betas_for_discretisation.cpu())
    expect(all(points[k].shape == same_cloud[k].shape for k in points),
           f"BFTQ frontier: {len(points['frontier_qc'])} points against the CPU's "
           f"{len(same_cloud['frontier_qc'])} on the same cloud")
    frontier_err = max(float(np.abs(points[k] - same_cloud[k]).max()) for k in points)
    expect(frontier_err <= BFTQ_TOLERANCE, f"BFTQ frontier: card against CPU {frontier_err!r}")
    print(f"BFTQ frontier of phase 23's agent: {len(points['qc'])} points, Q within "
          f"{cloud_err!r} of the CPU network's; {len(points['frontier_qc'])} on the frontier, "
          f"within {frontier_err!r} of the CPU's frontier of the same cloud, {frontier_s!r} s "
          f"(the CPU network's own cloud gives {len(cpu_points['frontier_qc'])})")
    return {"display_olop_agent": {"launches": got["launches"],
                                   "s_per_step": got["seconds"] / steps},
            "attention_matrix": {"launches": dict(NO_LAUNCHES),
                                 "s": attention_s},
            "bftq_frontier": {"launches": dict(NO_LAUNCHES),
                              "s": frontier_s}}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    sys.path.insert(0, str(REPO))
    from rl_agents_torch.agents.tree_search.common import allocation
    from rl_agents_torch.ops import kl_bound as kl_module

    phase("1. card")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    phase("2. build")
    started = time.time()
    library = kl_module.build()
    print(f"kl_bound built in {time.time() - started!r} s: {library.relative_to(REPO)}")
    log = library.with_suffix(".so.log")
    if log.is_file():
        print(log.read_text().strip())

    phase("3. kernels against their plain versions")
    dense = check_kl_bound(dev)
    kernels = [dense, check_kl_bound_indexed(dev), check_kl_bounds_pair(dev, dense)]

    cartpole = json.loads((CONFIGS / "CartPoleEnv" / "env.json").read_text())
    cartpole["max_episode_steps"] = AGENT_MAX_STEPS
    paths = {}
    phase("4. OLOP batch path")
    paths["olop_batch_plans"], olop_actions = check_olop_batch_path(dev)
    phase("5. OLOP agent path")
    # one kl_bound_indexed_ launch per planning episode
    paths["olop_agent"] = check_agent_path(dev, "OLOPAgent", cartpole, dict(AGENT_CONFIG), 0,
                                           allocation(AGENT_CONFIG["budget"], GAMMA)[0])
    phase("6. MCTS batch path")
    paths["mcts_batch_plans"] = check_mcts_batch_path(dev)
    phase("7. MCTS agent path")
    paths["mcts_agent"] = check_agent_path(dev, "MCTSAgent", cartpole,
                                           CONFIGS / "CartPoleEnv" / "MCTSAgent.json", 0, 0)
    phase("8. MDP-GapE batch path")
    paths["mdp_gape_batch_plans"] = check_gape_batch_path(dev)
    phase("9. MDP-GapE agent path")
    garnet = json.loads((CONFIGS / "FiniteMDPEnv" / "env_garnet.json").read_text())
    garnet["max_episode_steps"] = GARNET_AGENT_STEPS
    paths["mdp_gape_agent"] = check_agent_path(
        dev, "MDPGapEAgent", garnet, CONFIGS / "FiniteMDPEnv" / "agents" / "mdp-gape.json", 0, 0,
        kl_bounds_pair_per_plan=GAPE_KL_LAUNCHES)
    phase("10. stochastic GBOP batch path")
    if allocation(SAILING_BUDGET, SAILING_GAMMA) != (GBOP["episodes"], GBOP["horizon"]):
        raise AssertionError("gbop.json's budget no longer splits into 3 episodes x horizon 55")
    paths["gbop_stochastic_batch_plans"] = check_gbop_batch_path(dev)
    phase("11. GBOP-D batch path")
    paths["gbop_d_batch_plans"] = check_gbop_d_batch_path(dev)
    phase("12. OPD batch path")
    paths["opd_batch_plans"] = check_opd_batch_path(dev)
    phase("13. Sailing agent paths")
    sailing = json.loads((CONFIGS / "SailingEnv" / "env.json").read_text())
    sailing["max_episode_steps"] = SAILING_AGENT_STEPS
    agents = CONFIGS / "SailingEnv" / "agents"
    paths["gbop_stochastic_agent"] = check_agent_path(
        dev, "StochasticGraphBasedPlannerAgent", sailing, agents / "gbop.json", 0, 0,
        kl_bounds_pair_per_plan=GBOP_KL_LAUNCHES)
    paths["gbop_d_agent"] = check_agent_path(dev, "GraphBasedPlannerAgent", sailing,
                                             agents / "gbop-d.json", 0, 0)
    paths["opd_agent"] = check_agent_path(dev, "DeterministicPlannerAgent", sailing,
                                          agents / "opd.json", 0, 0)
    phase("14. highway batch paths")
    olop_config = json.loads((CONFIGS / "HighwayEnv" / "agents" / "OLOPAgent" / "kl-olop.json")
                             .read_text())
    if (olop_config["budget"], olop_config["gamma"]) != (HW_OLOP_BUDGET, HW_OLOP_GAMMA) \
            or allocation(HW_OLOP_BUDGET, HW_OLOP_GAMMA) != (HW_OLOP["episodes"],
                                                              HW_OLOP["horizon"]):
        raise AssertionError("kl-olop.json no longer splits into 72 episodes x horizon 6")
    highway = check_highway_batch_paths(dev)
    for path, result in highway.items():
        paths[path] = result["launches"]
    phase("15. highway agent paths")
    paths.update(check_highway_agent_paths(dev))
    print(json.dumps({"highway_batch_paths": {
        path: {key: value for key, value in result.items() if key != "launches"}
        for path, result in highway.items()}}))
    learner = {}
    phase("16. models")
    reset_launches()
    learner["ego_attention_models"] = check_models(dev)
    phase("17. DQN agent path")
    learner["dqn_highway_agent"] = check_dqn_object_path(dev)
    dqn_agent = learner["dqn_highway_agent"].pop("agent")
    dqn_handle = learner["dqn_highway_agent"].pop("handle")
    phase("18. fused actor-learner")
    learner["dqn_fused"] = check_fused_learner(dev)
    for path, result in learner.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"dqn_learner": learner}))
    slice7 = {}
    phase("19. dynamic programming")
    for path, result in check_dynamic_programming(dev).items():
        slice7[path] = result
    phase("20. MCTS-with-prior batch path")
    slice7["mcts_prior_batch_plans"] = check_mcts_prior_batch_path(dev)
    phase("21. MCTS-with-prior agent paths")
    slice7.update(check_mcts_prior_agent_paths(dev))
    phase("22. FTQ")
    slice7["ftq_highway_agent"] = check_ftq(dev)
    phase("23. BFTQ")
    slice7["bftq"] = check_bftq(dev)
    bftq_agent, bftq_state = slice7["bftq"].pop("agent"), slice7["bftq"].pop("state")
    for path, result in slice7.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"slice7": slice7}))
    slice8 = {}
    phase("24. MCTS-DPW batch path")
    print(card)
    slice8["mcts_dpw_batch_plans"] = check_mcts_dpw_path(dev)
    phase("25. closed-loop MCTS paths")
    print(card)
    slice8.update(check_closed_loop_paths(dev))
    phase("26. BRUE paths")
    print(card)
    slice8.update(check_brue_paths(dev))
    phase("27. sparse sampling paths")
    print(card)
    slice8.update(check_sparse_sampling_paths(dev))
    phase("28. CEM agent paths")
    print(card)
    slice8.update(check_cem_paths(dev))
    phase("29. PlaTyPOOS agent path")
    print(card)
    slice8["platypoos_highway_agent"] = check_platypoos_path(dev)
    phase("30. TrailBlazer")
    print(card)
    slice8["trailblazer_batched"] = check_trailblazer_path(dev)
    phase("31. PCG64 and the parity planners")
    print(card)
    slice8["pcg64_parity"] = check_parity_paths(dev)
    for path, result in slice8.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"slice8": slice8}))
    slice9 = {}
    phase("32. MiniGrid paths")
    print(card)
    slice9.update(check_minigrid_paths(dev))
    phase("33. grid and dynamics paths")
    print(card)
    slice9.update(check_grid_and_dynamics_paths(dev))
    phase("34. classic-control and parking agent paths")
    print(card)
    slice9.update(check_classic_and_parking_paths(dev))
    phase("35. robust control")
    print(card)
    slice9.update(check_robust_control_paths(dev))
    for path, result in slice9.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"slice9": slice9}))
    slice10 = {}
    phase("36. sharded actor-learner on a one-rank NCCL group")
    print(card)
    slice10["sharded_learner"] = check_distributed(dev)
    learner_states = slice10["sharded_learner"].pop("states")
    phase("37. sharded planner batch")
    print(card)
    slice10["sharded_planner_batch"] = check_sharded_planner_batch(dev, olop_actions)
    phase("38. serving")
    print(card)
    slice10["serving"] = check_serving(dev, dqn_agent, dqn_handle)
    phase("39. checkpoint and profiling")
    print(card)
    slice10["checkpoint_profiling"] = check_checkpoint_and_profiling(dev, learner_states)
    torch.distributed.destroy_process_group()
    for path, result in slice10.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"slice10": slice10}))
    slice11 = {}
    phase("40. MCTS on a stochastic env, draws injected")
    print(card)
    slice11.update(check_stochastic_mcts_paths(dev))
    phase("41. rollouts")
    print(card)
    slice11.update(check_rollouts(dev))
    phase("42. the display path")
    print(card)
    slice11.update(check_display_path(dev, dqn_agent, dqn_handle, bftq_agent, bftq_state))
    for path, result in slice11.items():
        paths[path] = result.pop("launches")
    print(json.dumps({"slice11": slice11}))
    for kernel in kernels:
        kernel["launches_by_path"] = {path: counts[kernel["name"]] for path, counts in paths.items()}
        kernel["launches"] = sum(kernel["launches_by_path"].values())
        if kernel["on_main_path"] and kernel["launches"] == 0:
            raise AssertionError(f"no path launched {kernel['name']}")
        if not kernel["on_main_path"] and kernel["launches"] != 0:
            raise AssertionError(f"{kernel['name']} is on no main path, yet launched "
                                 f"{kernel['launches']} times")

    phase("43. summary")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
