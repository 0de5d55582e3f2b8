#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipp_rl_tpu_torch``) on one card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for sm_90a) and
the CUDA toolkit; it exits non-zero, printing no result, without them.
Phases, each of which fails the run on a failed check (none is caught):

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``ipp_rl_tpu_torch/csrc/smallchol.cu`` from the repository's source;
2. each hand-written kernel against its plain PyTorch version on the card,
   at the main path's shapes, bit for bit: ``spd_inverse`` at B = 4096 and
   4097 (ragged tail) on random SPD 9x9 inputs and on inputs whose last
   pivot goes negative (the clamp); ``spd_trace_product`` on packed lower
   triangles in both sweep layouts of one B = 4096 replan step, (100, 45,
   4096) for the dense group and (4096, 45, 100) for the gather group
   (819,200 blocks), on a ragged ``inner`` and on clamped pivots.  Times:
   the kernel's device time from a CUDA graph of many launches replayed
   between CUDA events (``ms``), the per-call time of back-to-back calls
   between CUDA events (``call_ms``, host-paced for a short kernel), the
   wrapper's host time per call (``host_ms``), the plain version's and one
   library call's; for ``spd_inverse`` also the device time of one CTA's
   tile of 32 matrices (``one_cta_ms``: one thread's chain and a launch);
   ``spd_inverse_factor`` (S⁻¹ and the Cholesky factor of S⁻¹, the
   parent's edge update) at B = 1024, at 1025 (ragged) and on clamped
   pivots, whose overflowing factor must hold its inf and NaN entries where
   the plain version's are; ``edge_factor_gain`` (the search's edge update
   from S_raw and A to the edge factor and its gain) on the inputs of one
   descent step of phase 5 (beliefs after three commits, canonical actions,
   the adaptive mask) at B = 1024 and 1025 and on clamped pivots, NaN
   matched to NaN, with the parent's tail (the eager operations around
   ``spd_inverse_factor``) timed beside it; at the training path's batches,
   ``edge_factor_gain`` at B = ``TRAIN_ENVS`` (self-play) and
   ``ARENA_GAMES`` (arena) and ``spd_inverse`` on a commit's S at B =
   ``TRAIN_ENVS``; ``sweep_tap_blocks`` (the sweep's dense group from H's
   taps, ``csrc/sweep_taps.cu``) at the greedy cell's B = 4096 with bf16
   streams, classic's R = 1024 and CMA-ES's init at B = 8192 in float32,
   timed beside its bound, its plain version and the two-stage contraction
   it replaces (``library_ms``); the calls of that contraction (the
   counter ``sweep.dense_two_stage``) are read beside the launch counters
   and must be 0 on the three configurations' paths (phases 3, 9, 10) and
   one a step on the 1 m grid's (phase 16);
3. the greedy slice through its entry points: canonical
   ``ipp_rl_tpu_torch/config/example.yaml``, ``IPPWorld(cfg, fast_sweeps=True)``,
   ``GreedyPlanner.run`` with B = 4096 for 10 replan steps, with the launch
   counters set to 0 just before and read just after;
4. at B = 512, the same slice with the kernels and with their plain
   versions, from the same state and noise: the actions must agree and the
   metric curves must match;
5. the MCTS-zero deploy slice through its entry points at the canonical
   width: mission 0 of example.yaml (128 channels, 10 encoder blocks, 3 + 3
   head blocks, 16 planes on 100×100, 200 actions, 100 simulations,
   horizon 5, float32), seeded random weights from ``init_network``,
   ``ZeroPlanner.run`` in "reference" deploy mode at B = 1024 for 2 replan
   steps with the launch counters set to 0 just before and read just
   after; the root's visit total must be simulations − 1 for every mission
   at every replan, ``edge_factor_gain`` must launch once per descent step
   and ``spd_inverse_factor`` not at all; then one more replan split by CUDA
   events into descent
   (with the edge updates), leaf planes, network forward, and integrate +
   backup;
6. the committed 64-channel / 6-block checkpoint, read by the port's own
   reader, in "clean" deploy mode at B = 256 for 2 steps, with the kernels
   and with their plain versions from the same state, noise and generator
   seed, under ``torch.use_deterministic_algorithms``: actions and root
   visit counts identical, metric curves within ``METRIC_RTOL``;
7. MCTS-zero training through its entry point at the canonical width:
   mission 0 of example.yaml (128 channels, 10 encoder blocks, 100
   simulations, horizon 5, batch 96, 3 epochs, uniform replay, continuous
   update, dropout 0, float32) with seeded weights, cut to
   ``TRAIN_ENVS`` = 128 self-play environments, ``TRAIN_EPISODE_STEPS`` = 8
   steps per episode and ``TRAIN_ITERATIONS`` = 2 iterations of
   ``ZeroLearner.learn``, the launch counters set to 0 just before and read
   just after; then one ``arena_gate`` of ``ARENA_GAMES`` = 16 games of
   ``ARENA_STEPS`` = 4 steps.  Checks: ``spd_inverse`` and
   ``edge_factor_gain`` launch, ``edge_factor_gain`` once per descent step,
   self-play step and arena step (``spd_inverse_factor`` never); every
   running self-play root's visit total is simulations − 1; samples exist
   and value targets are finite and ≥ 0; losses and gradient norms are
   finite; parameters and BatchNorm running statistics moved; the
   deployment checkpoint reads back bitwise; ``LOSS_STEPS`` steps at
   ``LOSS_LR`` on one fixed batch bring the loss's excess over the target
   policies' entropy below ``LOSS_RATIO`` of the first step's.  Times:
   self-play (``SelfPlay.run`` alone) per step and per mission-step, the
   learner's own I/O around it (copy to the host, replay, npz), the train step
   (CUDA events; samples/s; forward + backward TFLOP/s counted as 3× the
   forward's hooked FLOPs), the arena per game step, each part's peak
   memory.  Then the committed checkpoint's self-play (E =
   ``TRAIN_AGREE_ENVS``, ``TRAIN_AGREE_STEPS`` steps, ``TRAIN_AGREE_SIMS``
   simulations) and one arena batch, with the kernels and with their plain
   versions from the same generator seeds, under deterministic
   algorithms: trajectories and arena totals identical.
8. the static baselines through ``run``: example.yaml, float32, B =
   ``STATIC_B`` = 4096, the lawnmower (step 5), the spiral (100
   waypoints), random discrete and random continuous, each for its whole
   budget-truncated mission, the launch counters set to 0 before each and
   read after: ``spd_inverse`` once per step (the ``step_position``
   commit), nothing else.  Checks: budgets never negative, waypoints in
   the box, uncertainty falls.  Times: ms per step;
9. CMA-ES through ``CMAESPlanner.run``: temperature_cmaes.yaml mission 0
   at full width (λ = 12, 20 generations, horizon 5, σ0 = 1, float32), B =
   ``CMAES_B`` = 1024, ``CMAES_STEPS`` = 3 replan steps, the counters set
   to 0 before and read after: per replan ``edge_factor_gain`` generations
   × horizon + horizon (the fitness's per-waypoint edge updates, the
   greedy plan's included), ``spd_trace_product`` two per greedy horizon
   step, ``spd_inverse`` horizon + 1 (the greedy horizon's hypothetical
   commits and the step's commit), ``spd_inverse_factor`` none; one more
   replan and commit split by CUDA events into greedy init, fitness, CMA
   update (eigh, sort, rank updates) and commit; peak memory; one fitness
   call at the generation's B·λ members and one at the greedy plan's B,
   each on the host clock with and without a synchronise and once under
   ``torch.profiler`` (device kernels, host synchronisations, the
   device's busy time and idle share of the call).  Then at B =
   ``CMAES_AGREE_B`` = 32 for 2 replans, with the kernels and with their
   plain versions, from one state, noise and generator: waypoints, budgets
   and metric curves identical.  Phase 2 also holds the kernels at this
   slice's shapes: ``spd_inverse`` on a ``step_position`` commit's S at B =
   4096 (padded rows, rf = 1 and 2), ``edge_factor_gain`` on the fitness's
   inputs at B·λ = 12288 and 12289 (per-sample R, (B·λ, N) mask) and
   ``spd_trace_product`` on the greedy init's sweep at B = 1024;
10. classic MCTS through ``Planner.run``: example.yaml, float32, the
   reference's knobs (``CLASSIC_KNOBS``: 100 simulations, horizon 5, γ 0.95,
   c 2, k 4, α 0.75, ε 0.2 / 0.5, radius 10, no GCB), B = ``CLASSIC_B`` =
   1024 for ``CLASSIC_STEPS`` = 2 replan steps, the counters set to 0
   before and read after: per replan ``edge_factor_gain`` S·(Hc + H) =
   1100 (every descent and rollout step of every row, in lockstep),
   ``spd_trace_product`` two per sweep (2200), ``spd_inverse`` one (the
   commit), ``spd_inverse_factor`` none; every root's visit total equals
   the simulation count; uncertainty falls.  The run's replans and
   commits split by CUDA events into the sweeps, the edge updates with
   their rank-M updates, the descent's UCT and tree writes, the rollout
   policy's rest, the backup and the commit; peak memory.  Then
   root-parallel: W = 4 workers of 25 simulations at B = 256 (R = 1024
   rows), one replan: launches 275 / 550 / 1, each worker's root visits
   25 and each mission's 100, the action the best merged per-action mean;
11. classic MCTS at B = ``CLASSIC_AGREE_B`` = 32, 16 simulations, one
   replan and its commit with W = 1 and with W = 2 and GCB rollouts, with
   the kernels and with their plain versions from one state, noise and
   generator seed: the trees (``CLASSIC_TREE_FIELDS``), actions, waypoints
   and metrics identical;
12. the port's entry points as subprocesses with implicit training
   refused (``IPP_ALLOW_IMPLICIT_TRAINING=0``): ``python -m
   ipp_rl_tpu_torch.main`` on example.yaml with its four missions (the
   mcts_zero one with the committed checkpoint's hyper-parameters and
   directory) and spiral, random continuous, classic MCTS (phase 10's
   knobs) and CMA-ES (λ 12, 20 generations, horizon 5) added, B = 32, 8
   steps: exit 0, eight KPI rows, every mission's final uncertainty below
   its prior, the pickle loads, the plots exist (``--no-plots`` where
   matplotlib is absent), and the kernel launches it reports; then
   ``python -m ipp_rl_tpu_torch.tools.train_zero`` at a tiny size: exit 0
   and a three-row ``eval.json``; the two run side by side.  Outputs under
   ``chiprun_out/entry_points/``.  Phase 2 also holds ``spd_trace_product``
   on each launch of one classic sweep (R = 1024, float32 streams, per-row
   masks) and ``edge_factor_gain`` on that step's edge inputs.
13. deployment through its entry points at one mission (B = 1):
   ``IPPMissionNode`` on example.yaml's mission 0 (mcts_zero with the
   committed checkpoint, as phase 12 runs it) for ``DEPLOY_ZERO_NODE_STEPS``
   steps and a greedy node for its whole mission; ``ClosedLoopMission``
   greedy for its whole budget with tracking noise 0 and
   ``DEPLOY_TRACKING_STD``, and mission 0 for ``DEPLOY_ZERO_CYCLES`` cycles
   with that noise; the counters set to 0 before the first node and read
   after the last loop: ``spd_inverse`` once per commit (the planner's, and
   the commit at the actual pose), ``edge_factor_gain`` once per zero
   descent step, ``spd_trace_product`` launched, ``spd_inverse_factor`` not.
   Checks: every flown trajectory ends within ``TRAJECTORY_END_TOL_M`` of its
   waypoint (under tracking noise, within one sampling interval's flight),
   uncertainty falls, the budget falls every cycle.  Times: ms per node
   step; ms per cycle split into plan, fly (the host's C++ min-snap) and
   measure + commit.  Then a greedy loop with tracking noise, with the
   kernels and with their plain versions from one seed: flight logs
   identical.  The min-snap library is built by g++ from the port's source
   beside the kernels (phase 1);
14. multi-device at world size 1 over NCCL (``initialize_multihost``): the
   20 x 20 large-grid mission (tests/test_sharded.py's config, float64,
   ``GRID_STEPS`` steps) row- and action-sharded against the dense oracle:
   identical actions, covariance and mean within 1e-8; the 48 x 48 grid of
   the same family (N = 2304, A = 4608, M = 9) in float32, sharded and
   dense, same actions; the sharded run's ms per step split by CUDA
   events into sweep, commit and collectives (nested), its set-up apart,
   its peak memory, ``spd_inverse`` twice per step; then two ranks on the
   one card over gloo (two ``--two-rank-worker`` subprocesses): a probe of
   all_reduce, all_gather_into_tensor and all_to_all_single on CUDA
   tensors and, where gloo takes them, the 20 x 20 mission at mp = 2 from
   the same draws: actions identical to one rank's, covariance within
   1e-8.  Phase 2 also holds ``spd_trace_product``, ``spd_inverse`` and
   ``edge_factor_gain`` at B = 1 (the deployed shapes) and ``spd_inverse``
   at the large-grid sweep's (A, 9, 9) and the sharded commit's (9, 9), in
   float32 and float64.
15. quality (allowance ``QUALITY_ALLOWANCE_S``): (a) the greedy mission on
   example.yaml's field at 2 m (``FINE_GRID``: M = 25, A = 800, N = 400, the
   kernels' warp route) at B = ``FINE_B`` for ``FINE_STEPS`` steps with
   the kernels and with their plain versions from one state and noise:
   actions identical, beliefs bitwise equal, ``spd_inverse`` and
   ``spd_trace_product`` launched; the step's ms and the trace product's
   within it (CUDA events around its launches); (b) the quality tool's evaluation
   (``tools/quality_vs_runtime.evaluate``) on the committed worlds
   (runs/quality_torch/worlds_s12345_b32.npz, the JAX script's) at the
   committed JAX reference's settings (runs/quality_torch/jax_reference.json:
   B = 32 whole budget-200 missions of 45 steps, greedy, random, CMA-ES,
   the committed checkpoint at 0 simulations and at 16 in clean mode,
   classic MCTS cut to 8 simulations), the counters set to 0 before and
   read after: for each row and each of the final tr(P) and RMSE, the
   per-world differences d from the reference must keep |mean d| ≤
   3·sd(d)/√32, and the rows' order by final tr(P) must be the reference's
   wherever the reference separates two rows by more than their bounds;
   (c) ``tools/eval_snapshots`` on a copy of the committed run directory
   (the deployed checkpoint, ``SNAPSHOT_SIMS`` simulations,
   ``SNAPSHOT_STEPS`` steps, B = 32, the committed worlds): its deploy row
   equals the quality tool's row for the same planner, worlds, steps and
   seed, both under deterministic algorithms.  Phase 2 also holds the four
   kernels' warp route (M = 13..32) at M = 13, 25 and 32 in float32 and
   float64: ``spd_inverse`` at (4096, M, M), on clamped pivots and (M = 25)
   on a fine-grid commit's S; ``spd_trace_product`` on the fine grid's two
   sweep launches at B = 256 ((256, 325, 400), (400, 325, 256)), on (256, T,
   400) random blocks for M = 13 and 32 and on a ragged (3, T, 33) launch
   with each kind of kernel (runtime-M, unrolled); ``spd_inverse_factor`` at
   (1024, M, M); ``edge_factor_gain`` at (1024, M, 400) with a per-mission
   mask (M = 25: a fine-grid descent step's inputs); times each at M = 25
   as at M = 9, ``spd_inverse`` (4096, M, M) and the sweep pair with each
   kind forced at M = 13, 25 and 32 in float32, and ``spd_inverse_factor``
   (1024, M, M) and ``edge_factor_gain`` (1024, M, 400) at M = 13, 25 and
   32 in float32 and float64.
16. the 1 m grid (allowance ``FINE_1M_ALLOWANCE_S``): example.yaml's field
   on ``FINE_1M_GRID`` (40 x 40 cells of 1 m: lattice M = 81, continuous
   M = 121, A = 3200, N = 1600; the kernels' CTA route): (a) greedy with
   fast sweeps at B = ``FINE_1M_B`` for ``FINE_1M_STEPS`` steps (a mission
   cut for time), counted from 0: ``spd_trace_product`` launched twice per
   step and ``spd_inverse`` once, uncertainty falls, budgets stay
   non-negative; ms per step, the sweep and the commit by CUDA events, the
   peak; (b) one step at B = ``FINE_1M_AGREE_B`` with the kernels and with
   their plain versions from one state and noise: actions identical,
   beliefs bitwise equal; (c) CMA-ES on temperature_cmaes.yaml on the same
   grid at B = ``FINE_1M_CMAES_B``, one replan, counted from 0 (the
   launches the path implies: ``edge_factor_gain`` 105), its ms, the
   fitness's share and the peak, then ``edge_factor_gain`` bitwise against
   its plain version on the replan's own first fitness inputs (192, 121,
   1600) (a whole plain replan at M = 121 takes too long).  Phase 2 also
   holds the CTA route (M >= 33, one CTA per matrix): timed and bitwise at
   the 1 m grid's shapes, ``spd_inverse`` (4096, 81, 81) and (4096, 121,
   121), ``spd_trace_product`` on the 1 m sweep's two launches at B = 16,
   ``spd_inverse_factor`` (1024, 81, 81), ``edge_factor_gain`` (192, 121,
   1600) with a per-member mask; and at M = ``CTA_M_CHECKED`` clamped
   pivots and float64 with the workspace in global memory, at M =
   ``CTA_M_RAGGED`` a trace-product CTA with empty slots and blocks across
   two o, and ``edge_factor_gain`` over a ragged column tile with a shared
   mask and the bf16 round trip.
17. the 2 m grid's CMA-ES and MCTS-zero (allowance ``FINE_2M_ALLOWANCE_S``;
   ``FINE_GRID``: continuous and lattice M = 25, N = 400, A = 800, the
   kernels' warp route): (a) CMA-ES on temperature_cmaes.yaml at full width
   (λ = 12, 20 generations, horizon 5) at B = ``FINE_2M_CMAES_B``, one
   replan after a warm-up at one generation, counted from 0: per replan
   ``edge_factor_gain`` G·H + H, ``spd_trace_product`` 2H, ``spd_inverse``
   H + 1, ``spd_inverse_factor`` 0; metrics finite, uncertainty falls,
   budgets non-negative; the peak; one more replan split by CUDA events;
   the replan's first fitness launch ((B·λ, 25, 400), per-member mask)
   bitwise against the plain version, and timed on it with its bound and
   the library call.  (b) the
   MCTS-zero deploy search on example.yaml at full width (128 channels, 10
   encoder blocks, 100 simulations) with seeded weights at B =
   ``FINE_2M_ZERO_B``, one replan after a warm-up at 2 simulations, counted
   from 0: ``edge_factor_gain`` once per descent step,
   ``spd_inverse_factor`` never, every root's visits simulations − 1,
   metrics finite; one descent step's edge inputs bitwise and timed; the
   replan split by CUDA events as in phase 5; the peak.
   Phase 17's B = 256 on 2 m cells is an assumed workload: no config of
   the repo sets 2 m cells.

Float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The last stdout line is ``{"ok": true, "device": {...}}``;
the lines before it carry the per-kernel JSON and the card.  A fuller
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, config_from_dict, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.models.networks import plane_channels
from ipp_rl_tpu_torch.planners import (
    ClassicMCTSPlanner,
    CMAESPlanner,
    GreedyPlanner,
    LawnmowerPlanner,
    RandomContinuousPlanner,
    RandomDiscretePlanner,
    SpiralPlanner,
    cmaes,
)
from ipp_rl_tpu_torch.planners.base import sweep_rewards
from ipp_rl_tpu_torch.planners.zero import ZeroPlanner
from ipp_rl_tpu_torch.planners.zero.arena import Arena
from ipp_rl_tpu_torch.planners.zero.features import init_history, push_history
from ipp_rl_tpu_torch.planners.zero.learn import ZeroLearner, checkpoint_variables, load_checkpoint
from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS
from ipp_rl_tpu_torch.planners.zero.selfplay import SelfPlay
from ipp_rl_tpu_torch.planners.zero.train import (
    inference_dtype,
    init_network,
    predict_fn,
    reset_optimizer,
)
from ipp_rl_tpu_torch.serialization import read_checkpoint
from ipp_rl_tpu_torch.tools import eval_snapshots
from ipp_rl_tpu_torch.tools import quality_vs_runtime as qvr
from ipp_rl_tpu_torch.trajgen import planner as trajgen
from ipp_rl_tpu_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
M = 9  # measurement rows per action on the canonical config
T = M * (M + 1) // 2  # entries of a packed lower triangle
ACTIONS_PER_GROUP = 100  # each of the canonical config's two sweep groups
REPLAN_B, REPLAN_STEPS = 4096, 10
AGREE_B, AGREE_STEPS = 512, 4
ZERO_B, ZERO_STEPS = 1024, 2
ZERO_AGREE_B, ZERO_AGREE_STEPS = 256, 2
# phase 7: the training slice's scale cuts (canonical: 22 x 13 = 286
# environments, 40-step episodes, 40 iterations) and its arena gate
TRAIN_ENVS, TRAIN_EPISODE_STEPS, TRAIN_ITERATIONS = 128, 8, 2
ARENA_GAMES, ARENA_STEPS = 16, 4
# N steps at a fixed LR (the recipe's peak) on one fixed batch of the
# phase's data must bring its loss's excess over the policy targets'
# entropy (the cross-entropy's floor) below this share of the first step's.
# The loss falls in steps after plateaus: after 100 steps the share spread
# over 0.40-0.86 in four runs whose batches differed (before the learner's
# train steps ran under cuDNN's deterministic algorithms), so 200 are taken
LOSS_STEPS, LOSS_LR, LOSS_RATIO = 200, 5e-3, 0.8
TRAIN_AGREE_ENVS, TRAIN_AGREE_STEPS, TRAIN_AGREE_SIMS = 32, 4, 32
# phases 8 and 9: the static baselines and CMA-ES
STATIC_B = 4096
CMAES_B, CMAES_STEPS = 1024, 3
CMAES_AGREE_B, CMAES_AGREE_STEPS = 32, 2
# phases 10-12: classic MCTS with the reference's knobs (scripts/quality_parity.py:74-78)
CLASSIC_KNOBS = dict(type="mcts", num_simulations=100, episode_horizon=5, gamma=0.95, uct_c=2.0,
                     k=4.0, alpha=0.75, epsilon_expand=0.2, epsilon_rollout=0.5,
                     horizontal_spacing=10.0, use_gcb_rollout=False)
CLASSIC_B, CLASSIC_STEPS, CLASSIC_WORKERS = 1024, 2, 4
CLASSIC_AGREE_B, CLASSIC_AGREE_SIMS = 32, 16
ENTRY_POINTS_TIMEOUT_S = 600
# phases 13-14: the deployed loop (one mission), the large-grid missions
DEPLOY_ZERO_NODE_STEPS, DEPLOY_ZERO_CYCLES, DEPLOY_TRACKING_STD = 4, 3, 0.5
# a flown segment's last sample lies within this of its waypoint when the UAV
# tracks exactly (tests/test_mission_node.py's tolerance); from a perturbed
# start the sampler's last sample can fall up to one sampling interval short
# of the segment's end, as in the JAX package (bitwise-equal trajectories,
# tests/test_torch_mission_node.py), so there the bound is max_v x sampling_time
TRAJECTORY_END_TOL_M = 0.3
GRID_STEPS, LARGE_GRID_DIM = 4, 48
TWO_RANK_TIMEOUT_S = 180
NEW_PHASES_ALLOWANCE_S = 90
# tests/test_sharded.py:198-229 (20 x 20: N = 400, A = 800, M = 9)
LARGE_GRID_RAW = {
    "environment": {"x_dim": 20, "y_dim": 20, "resolution": 4},
    "sensor": {
        "type": "rgb_camera",
        "field_of_view": {"angle_x": 60, "angle_y": 60},
        "model": {"type": "altitude_dependent", "coeff_a": 0.05, "coeff_b": 0.2},
        "simulation": {"type": "gaussian_random_field", "cluster_radius": 5},
    },
    "mapping": {"fit_gaussian_process": True, "signal_variance": 1.82, "length_scale": 3.67,
                "noise_variance": 1.42, "nu": 1.5},
    "experiment": {
        "title": "large_grid",
        "constraints": {"dist_to_boundaries": 3, "min_altitude": 8, "max_altitude": 14,
                        "altitude_spacing": 6, "budget": 60},
        "scenario": {"adaptive": True, "value_threshold": 0.4, "interval_factor": 0},
        "uav": {"max_v": 2, "max_a": 2, "sampling_time": 2},
        "missions": [{"type": "greedy"}],
        "evaluation": {"repetitions": 1, "metrics": ["uncertainty"]},
    },
}
CLASSIC_TREE_FIELDS = ("parent", "action_in", "children", "num_children", "visits", "value_sum",
                       "budget", "wc_in", "next_free")
CHECKPOINT = ROOT / "runs" / "zero_canon_r5_best" / "checkpoints" / "shared_net.trained_model.ckpt"
# the committed checkpoint's hyper-parameters (tests/test_learning_artifact.py)
CHECKPOINT_HP = dict(num_channels=64, num_encoder_res_blocks=6, num_global_pooling_channels=32,
                     max_valid_action_distance=11.5, unfloored_value_head=True)
# phase 2's large-M route and phase 15: example.yaml's field on 20 x 20
# cells of 2 m has M = 25, A = 800, N = 400 (a finer grid than any config
# of the repository); the greedy mission on it, B x steps
FINE_GRID = {"x_dim": 20, "y_dim": 20, "resolution": 2}
FINE_B, FINE_STEPS = 256, 4
LARGE_M_CHECKED = (13, 25, 32)
# phase 15: the committed JAX reference (tests/test_torch_quality.py writes
# it) and its worlds; eval_snapshots' cut (16 simulations, 8 steps)
QUALITY_WORLDS = ROOT / "runs" / "quality_torch" / "worlds_s12345_b32.npz"
QUALITY_REFERENCE = ROOT / "runs" / "quality_torch" / "jax_reference.json"
SNAPSHOT_SIMS, SNAPSHOT_STEPS = 16, 8
QUALITY_ALLOWANCE_S = 150
# phase 2's CTA-route rows and phase 16: example.yaml's field (and
# temperature_cmaes.yaml's) on 40 x 40 cells of 1 m: lattice M = 81 (A =
# 3200, N = 1600), continuous M = 121; greedy B x steps (a mission cut for
# time), its agreement batch, CMA-ES B x one replan
FINE_1M_GRID = {"x_dim": 40, "y_dim": 40, "resolution": 1}
FINE_1M_B, FINE_1M_STEPS, FINE_1M_AGREE_B = 16, 4, 2
FINE_1M_CMAES_B = 16
FINE_1M_ALLOWANCE_S = 150
# phase 17: CMA-ES (temperature_cmaes.yaml) and the MCTS-zero deploy search
# (example.yaml, full width, seeded weights) on FINE_GRID, B x one replan:
# both drive edge_factor_gain's warp route (M = 25, N = 400)
FINE_2M_CMAES_B, FINE_2M_ZERO_B = 256, 256
FINE_2M_ALLOWANCE_S = 90
# the CTA route's clamped-pivot and float64 (global workspace) checks in
# phase 2: every M >= 33 runs the same code, and a plain version's time
# grows as M^3 (~20 s a call at M = 121 on the card)
CTA_M_CHECKED = 48
# and its ragged runs of blocks and column tiles
CTA_M_RAGGED = 33
# the kernels repeat their plain versions' operations in the same order,
# one rounding each: they are held to bitwise equality; the metric curves
# of the agreement phase to this relative tolerance
METRIC_RTOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    """Device time per call of fn(): a CUDA graph of `launches` calls,
    replayed between CUDA events, so the host sets no pace."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def host_ms(fn, iters: int) -> float:
    """Host time per call of fn(): enqueue only, no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


# ------------------------------------------------------------ bound model

def _cholesky_ops(m: int) -> int:
    """Operations of the unrolled Cholesky, counted one per add, multiply,
    divide, square root and compare."""
    return sum(2 * j + 3 + (m - j - 1) * (2 * j + 1)  # pivot (j mul, j sub, clamp,
               for j in range(m))  # sqrt, reciprocal), then the column below it


def _inverse_factor_ops(m: int) -> int:
    """The Cholesky + forward substitution shared by the kernels (one more
    per negation)."""
    ops = _cholesky_ops(m)
    for j in range(m):
        ops += 1  # Li diagonal reciprocal
        ops += sum(2 * (i - j) + 1 for i in range(j + 1, m))  # Li entries
    return ops


def inverse_ops(m: int) -> int:
    entries = sum(2 * (m - i) - 1 for i in range(m) for _ in range(i + 1))
    return _inverse_factor_ops(m) + entries


def inverse_factor_ops(m: int) -> int:
    return inverse_ops(m) + _cholesky_ops(m)


def edge_ops(m: int, n: int, masked: bool, round_bf16: bool) -> int:
    """Operations of edge_factor_gain for one mission: the symmetrised
    lower triangle (add, halve, add R or 0), the inverse and its factor,
    Uᵀ·A (m products and m − 1 sums per entry), the optional round trip,
    the squares and their sums over m, the mask, and the gain's n − 1 sums
    (the warp's zero padding is not counted)."""
    sym = 3 * m * (m + 1) // 2
    wct = m * n * (2 * m - 1) + (2 * m * n if round_bf16 else 0)
    sq = m * n + (m - 1) * n + (n if masked else 0)
    return sym + inverse_factor_ops(m) + wct + sq + n - 1


def trace_ops(m: int) -> int:
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    entries = sum(2 * (m - i) - 1 + 1 + (i != j) for i, j in pairs) + len(pairs) - 1
    return _inverse_factor_ops(m) + entries


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase

def random_spd(n: int, gen: torch.Generator, m: int = M,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    A = torch.randn((n, m, m), generator=gen, device="cuda", dtype=dtype)
    return A @ A.mT + 0.5 * torch.eye(m, device="cuda", dtype=dtype)


def make_indefinite(S: torch.Tensor) -> torch.Tensor:
    """S with its last pivot driven negative, so the kernels clamp it."""
    S = S.clone()
    S[..., -1, -1] -= 2.0 * S.diagonal(dim1=-2, dim2=-1).sum(-1)
    return S


def packed(S: torch.Tensor, outer: int, inner: int) -> torch.Tensor:
    """(outer * inner, m, m) blocks → the kernel's (outer, T, inner) layout."""
    t = smallchol.packed_size(S.shape[-1])
    return smallchol.pack_lower(S).view(outer, inner, t).transpose(1, 2).contiguous()


def compare_with_nan(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Bitwise equal where finite, inf where the plain version has inf, NaN
    where it has NaN (an overflowing factor of a clamped inverse)."""
    same = bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
    log(f"  {name}: bitwise_equal_or_both_nan={same}, "
        f"{int((~torch.isfinite(want)).sum())} non-finite entries in the plain version")
    check(same, f"{name}: kernel differs from its plain version")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    check(bool(torch.isfinite(want).all()), f"{name}: plain output not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale
    same = bool(torch.equal(got, want))
    log(f"  {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"bitwise_equal={same} (tolerance: bitwise)")
    check(same, f"{name}: kernel differs from its plain version ({rel:.3e})")
    return {"max_abs_err": err, "max_rel_err": rel}


def times(fn, graph_launches: int, calls: int) -> dict:
    return {"ms": graph_ms(fn, graph_launches), "call_ms": cuda_ms(fn, calls),
            "host_ms": host_ms(fn, calls)}


def kernel_phase(gen: torch.Generator) -> list:
    log("== kernels against their plain versions")
    rows = []

    # spd_inverse: the commit's B innovation inverses per replan step
    S = random_spd(REPLAN_B, gen)
    inv_err = compare("spd_inverse B=4096", kernels.spd_inverse(S), smallchol.spd_inverse(S))
    S_tail = random_spd(REPLAN_B + 1, gen)
    compare("spd_inverse B=4097", kernels.spd_inverse(S_tail), smallchol.spd_inverse(S_tail))
    S_bad = make_indefinite(random_spd(REPLAN_B + 1, gen))
    got_bad = kernels.spd_inverse(S_bad)
    compare("spd_inverse indefinite (clamped pivot)", got_bad, smallchol.spd_inverse(S_bad))
    check(got_bad[:, -1, -1].abs().min().item() > 1e29, "clamped pivot: expected ~1e30 entries")
    ref = torch.linalg.inv(S.double())
    check((kernels.spd_inverse(S).double() - ref).abs().max().item()
          <= 1e-3 * ref.abs().max().item(), "spd_inverse: far from torch.linalg.inv (f64)")
    t = times(lambda: kernels.spd_inverse(S), graph_launches=200, calls=200)
    S_cta = S[:32]
    t["one_cta_ms"] = graph_ms(lambda: kernels.spd_inverse(S_cta), 200)
    plain_ms = cuda_ms(lambda: smallchol.spd_inverse(S), 10)
    lib_ms = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(S)), 50)
    nbytes = 2 * S.numel() * S.element_size()
    b_ms, b_by = bound(nbytes, REPLAN_B * inverse_ops(M))
    rows.append({
        "name": "spd_inverse", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/ops/pallas_kernels.py:71",
        "shape": [REPLAN_B, M, M], "dtype": "float32",
        **inv_err, **t, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes": nbytes, "library_ms": lib_ms,
        "library_call": "torch.cholesky_inverse(torch.linalg.cholesky(S))",
    })

    # spd_trace_product: both sweep groups of one replan step, 2 x 100 x 4096
    # blocks, each group in its own packed layout
    A, B = ACTIONS_PER_GROUP, REPLAN_B
    n = 2 * A * B
    S_full, G_full = random_spd(n, gen), random_spd(n, gen)
    layouts = {  # name: (outer, inner): the two-stage route's and the gather and taps groups'
        "dense (100, 45, 4096)": (A, B),
        "gather (4096, 45, 100)": (B, A),
    }
    tr_err = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    per_layout = {}
    for k, (name, (outer, inner)) in enumerate(layouts.items()):
        part = slice(k * A * B, (k + 1) * A * B)
        Sp, Gp = packed(S_full[part], outer, inner), packed(G_full[part], outer, inner)
        err = compare(f"spd_trace_product {name}", kernels.spd_trace_product_packed(Sp, Gp),
                      smallchol.spd_trace_product_packed(Sp, Gp))
        tr_err = {key: max(tr_err[key], err[key]) for key in tr_err}
        per_layout[name] = {
            **times(lambda: kernels.spd_trace_product_packed(Sp, Gp), graph_launches=20,
                    calls=20),
            "plain_ms": cuda_ms(lambda: smallchol.spd_trace_product_packed(Sp, Gp), 3, warmup=1),
        }
    Sr, Gr = packed(S_full[:3 * 1001], 3, 1001), packed(G_full[:3 * 1001], 3, 1001)
    compare("spd_trace_product ragged (3, 45, 1001)", kernels.spd_trace_product_packed(Sr, Gr),
            smallchol.spd_trace_product_packed(Sr, Gr))
    Sb = packed(make_indefinite(S_full[:B * 7]), B, 7)
    Gb = packed(G_full[:B * 7], B, 7)
    got_bad = kernels.spd_trace_product_packed(Sb, Gb)
    compare("spd_trace_product indefinite (clamped pivot)", got_bad,
            smallchol.spd_trace_product_packed(Sb, Gb))
    check(got_bad.abs().min().item() > 1e20, "clamped pivot: expected huge trace products")
    lib_ms = cuda_ms(
        lambda: torch.cholesky_solve(G_full, torch.linalg.cholesky(S_full))
        .diagonal(dim1=-2, dim2=-1).sum(-1),
        3, warmup=1,
    )
    nbytes = (2 * T + 1) * n * S_full.element_size()
    b_ms, b_by = bound(nbytes, n * trace_ops(M))
    rows.append({
        "name": "spd_trace_product", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/ops/smallchol.py:51",
        "shape": [n, T], "dtype": "float32", "layouts": per_layout,
        **tr_err,
        **{key: sum(v[key] for v in per_layout.values())
           for key in ("ms", "call_ms", "host_ms", "plain_ms")},
        "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
        "library_ms": lib_ms,
        "library_call": "torch.cholesky_solve(G, torch.linalg.cholesky(S)).diagonal(...).sum(-1)"
                        " on the full (n, 9, 9) blocks",
    })
    rows.append(inverse_factor_row(gen))
    rows.append(edge_factor_gain_row(gen))
    continuous = continuous_shape_checks(gen)
    classic = classic_shape_checks(gen)
    deploy = deploy_shape_checks(gen)
    large = large_m_rows(gen)
    cta = cta_m_rows(gen)
    for r in rows:
        r["m_range"] = "any M >= 1"
        r["m25"] = large[r["name"]]["m25"]
        if "kinds" in large[r["name"]]:  # K1 and K2 with each kind of warp-route kernel
            r["warp_kinds"] = large[r["name"]]["kinds"]
        if "warp_m" in large[r["name"]]:  # K3 and the edge at M = 13, 25, 32
            r["warp_m"] = large[r["name"]]["warp_m"]
        r["large_m_checks"] = large[r["name"]]["checks"]
        r["m81_m121"] = cta[r["name"]]["rows"]
        r["cta_m_checks"] = cta[r["name"]]["checks"]
        r["max_abs_err"] = max(r["max_abs_err"], large[r["name"]]["max_abs_err"],
                               cta[r["name"]]["max_abs_err"])
        if r["name"] in continuous:
            r["continuous_checks"] = continuous[r["name"]]
        if r["name"] in classic:
            r["classic_checks"] = classic[r["name"]]
        if r["name"] in deploy:
            r["deploy_checks"] = deploy[r["name"]]
    rows.append(sweep_taps_row(gen))
    rows[-1]["deploy_checks"] = deploy["sweep_tap_blocks"]
    log(f"  spd_inverse on 32 matrices (one CTA): {rows[0]['one_cta_ms']:.4f} ms device")
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms device (graph), {r['call_ms']:.4f} ms "
            f"per back-to-back call, host {r['host_ms']:.4f} ms per call; plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_bytes'] / 1e6:.2f} MB), "
            f"{r['bound_ms'] / r['ms']:.0%} of it")
    for name, v in per_layout.items():
        log(f"    spd_trace_product {name}: {v['ms']:.4f} ms device, "
            f"{v['call_ms']:.4f} ms per call, plain {v['plain_ms']:.3f} ms")
    return rows


#: the sweep's dense group at each path's batch: name: (B, bf16 streams)
TAPS_SHAPES = {"greedy": (REPLAN_B, True), "classic": (1024, False), "cmaes_init": (8192, False)}


def sweep_taps_row(gen: torch.Generator) -> dict:
    """``sweep_tap_blocks`` at the three paths' batches on example.yaml's
    dense group (Ag = 100, Mg = 9, N = 100, KT = 4), float32 beliefs after
    three commits: bitwise its plain version; device, call and host ms, the
    plain version's and the two-stage contraction's (its blocks alone, the
    route the kernel replaced) ms; the bound from the bytes read and
    written once (P, Q, S, G and the tables) and the entries' operations."""
    from ipp_rl_tpu_torch.ops import kalman
    from ipp_rl_tpu_torch.ops.sensor_model import build_sweep_plan

    log("== sweep_tap_blocks: the sweep's dense group from H's taps")
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    (g,) = [g for g in world.sweep_batched["groups"] if g["kind"] == "taps"]
    plan = build_sweep_plan(world.table, x_dim=cfg.environment.x_dim, y_dim=cfg.environment.y_dim)
    fits, kernels.sweep_taps_fit = kernels.sweep_taps_fit, lambda *args: False
    try:
        (dense,) = [d for d in kalman.prepare_batched_sweep(plan, torch.float32)["groups"]
                    if d["kind"] == "dense"]
    finally:
        kernels.sweep_taps_fit = fits
    Mg, KT, Ag = g["cells"].shape
    t_entries = smallchol.packed_size(Mg)
    N = world.H.shape[-1]
    tables = sum(g[k].numel() * g[k].element_size() for k in ("cells", "weights", "diag"))
    shapes = {}
    max_err = 0.0
    for name, (B, fast) in TAPS_SHAPES.items():
        state = world.init_state(B, gen)
        for _ in range(3):
            a = torch.randint(0, world.num_actions, (B,), generator=gen, device="cuda")
            state = world.step_index(state, a, generator=gen)
        P = state.cov
        mask = adaptive_mask(state.mean, torch.diagonal(P, dim1=-2, dim2=-1), 0.4, 0.0)
        stream = torch.bfloat16 if fast else torch.float32
        Q = torch.matmul((P * mask[:, None, :]).to(stream), P.to(stream))
        args = (P, Q, g["cells"], g["weights"], g["diag"], 0.0, fast)
        got, want = kernels.sweep_tap_blocks(*args), smallchol.sweep_tap_blocks(*args)
        for part, x, y in zip("SG", got, want):
            max_err = max(max_err, compare(f"sweep_tap_blocks {name} B={B} {part}", x, y)
                          ["max_abs_err"])
        nbytes = (P.numel() * P.element_size() + Q.numel() * Q.element_size()
                  + 2 * B * t_entries * Ag * 4 + tables)
        ops = 2 * B * (t_entries * Ag * (2 * KT * KT + 2 * KT) + 2 * N * N) + B * t_entries * Ag
        b_ms, b_by = bound(nbytes, ops)
        shapes[name] = {
            "shape": [B, N, N], "stream": str(stream).removeprefix("torch."),
            **times(lambda: kernels.sweep_tap_blocks(*args), graph_launches=20, calls=20),
            "plain_ms": cuda_ms(lambda: smallchol.sweep_tap_blocks(*args), 3, warmup=1),
            "library_ms": cuda_ms(lambda: kalman._two_stage_blocks(
                P, Q, dense, 0.0, stream, torch.float32), 5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
        }
        v = shapes[name]
        log(f"  sweep_tap_blocks {name} (B = {B}, {v['stream']} streams): kernel {v['ms']:.4f} ms "
            f"device, {v['call_ms']:.4f} per call, host {v['host_ms']:.4f}; plain "
            f"{v['plain_ms']:.3f}, two-stage {v['library_ms']:.3f} ms; bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.1f} MB), {b_ms / v['ms']:.0%} of it")
        del state, P, Q, got, want
    head = shapes["greedy"]
    return {
        "name": "sweep_tap_blocks", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/sweep_taps.cu",
        "replaces": "ipp_rl_tpu/ops/kalman.py:429",
        "shape": head["shape"], "dtype": "float32", "max_abs_err": max_err,
        "max_rel_err": 0.0, "shapes": shapes,
        **{k: head[k] for k in ("ms", "call_ms", "host_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "bound_bytes")},
        "library_call": "ops/kalman._two_stage_blocks (the two-stage contraction's S and G)",
        "m_range": f"N^2 values of the accumulation dtype <= {kernels.TAPS_SHARED_BYTES} B, "
                   f"KT <= {kernels.TAPS_MAX}",
        "m25": None, "m81_m121": None,
    }


def inverse_factor_row(gen: torch.Generator) -> dict:
    """spd_inverse_factor: the B innovation matrices of one descent step of
    the zero phase (every tree edge priced in that step)."""
    S = random_spd(ZERO_B, gen)
    inv, U = kernels.spd_inverse_factor(S)
    want_inv, want_U = smallchol.spd_inverse_factor(S)
    err = compare("spd_inverse_factor B=1024 (S^-1)", inv, want_inv)
    err_u = compare("spd_inverse_factor B=1024 (U)", U, want_U)
    err = {k: max(err[k], err_u[k]) for k in err}
    check((U @ U.mT - want_inv).abs().max().item() <= 1e-3 * want_inv.abs().max().item(),
          "spd_inverse_factor: U U^T is far from S^-1")
    S_tail = random_spd(ZERO_B + 1, gen)
    for got, want, part in zip(kernels.spd_inverse_factor(S_tail),
                               smallchol.spd_inverse_factor(S_tail), ("S^-1", "U")):
        compare(f"spd_inverse_factor B=1025 ({part})", got, want)
    S_bad = make_indefinite(random_spd(ZERO_B + 1, gen))
    for got, want, part in zip(kernels.spd_inverse_factor(S_bad),
                               smallchol.spd_inverse_factor(S_bad), ("S^-1", "U")):
        compare_with_nan(f"spd_inverse_factor indefinite (clamped pivot, {part})", got, want)
    t = times(lambda: kernels.spd_inverse_factor(S), graph_launches=200, calls=200)
    plain_ms = cuda_ms(lambda: smallchol.spd_inverse_factor(S), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(
        torch.cholesky_inverse(torch.linalg.cholesky(S))), 50)
    nbytes = 3 * S.numel() * S.element_size()
    b_ms, b_by = bound(nbytes, ZERO_B * inverse_factor_ops(M))
    return {
        "name": "spd_inverse_factor", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/ops/kalman.py:107",
        "shape": [ZERO_B, M, M], "dtype": "float32",
        **err, **t, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes": nbytes, "library_ms": lib_ms,
        "library_call": "torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(S)))",
    }


def descent_step_inputs(world, B: int, gen: torch.Generator):
    """The edge update's inputs as one descent step of phase 5 builds them:
    GP-prior beliefs after three commits of random actions of the canonical
    table, the adaptive mask of that state, random actions a, A = H[a]·P
    and S_raw = A·H[a]ᵀ."""
    state = world.init_state(B, gen)
    for _ in range(3):
        step = torch.randint(0, world.num_actions, (B,), generator=gen, device="cuda")
        state = world.step_index(state, step, generator=gen)
    a = torch.randint(0, world.num_actions, (B,), generator=gen, device="cuda")
    scen = world.cfg.scenario
    mask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor)
    H = world.H[a]
    A = H @ state.cov
    return A @ H.mT, A, world.R_diag, a, mask


def previous_edge_tail(S_raw, A, R_table, a, mask):
    """The edge update's tail as the parent ran it (the unrolled eager
    operations around K3), for the comparison only."""
    S = 0.5 * (S_raw + S_raw.mT) + torch.diag_embed(R_table[a])
    _, U = kernels.spd_inverse_factor(S.contiguous())
    WcT = U.mT @ A
    return WcT, torch.sum(torch.sum(WcT * WcT, dim=-2) * mask, dim=-1)


def library_edge_tail(S_raw, A, R_table, a, mask):
    S = 0.5 * (S_raw + S_raw.mT) + torch.diag_embed(R_table[a])
    U = torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(S)))
    WcT = U.mT @ A
    sq = torch.sum(WcT * WcT, dim=-2)
    return WcT, torch.sum(sq if mask is None else sq * mask, dim=-1)


def edge_factor_gain_row(gen: torch.Generator) -> dict:
    """edge_factor_gain: the B edge updates of one descent step of the zero
    phase, at B = 1024, at 1025 (ragged) and on clamped pivots."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    args = descent_step_inputs(world, ZERO_B, gen)
    S_raw, A, R, a, mask = args
    B, m, n = A.shape
    WcT, gain = kernels.edge_factor_gain(*args)
    want_wct, want_gain = smallchol.edge_factor_gain(*args)
    err = compare(f"edge_factor_gain B={B} (WcT)", WcT, want_wct)
    err_g = compare(f"edge_factor_gain B={B} (gain)", gain, want_gain)
    err = {k: max(err[k], err_g[k]) for k in err}
    ref_wct, ref_gain = library_edge_tail(*(x.double() if x.is_floating_point() else x
                                            for x in args))
    check((gain.double() - ref_gain).abs().max().item() <= 1e-4 * ref_gain.abs().max().item(),
          "edge_factor_gain: gain far from the float64 library route")
    check(torch.allclose((WcT.double().mT @ WcT.double()), ref_wct.mT @ ref_wct, rtol=1e-3,
                         atol=1e-5), "edge_factor_gain: Wc Wc^T far from the float64 library route")
    tail = descent_step_inputs(world, ZERO_B + 1, gen)
    for got, want, part in zip(kernels.edge_factor_gain(*tail),
                               smallchol.edge_factor_gain(*tail), ("WcT", "gain")):
        compare(f"edge_factor_gain B={ZERO_B + 1} ({part})", got, want)
    bad = list(descent_step_inputs(world, ZERO_B + 1, gen))
    bad[0] = make_indefinite(bad[0])
    for got, want, part in zip(kernels.edge_factor_gain(*bad),
                               smallchol.edge_factor_gain(*bad), ("WcT", "gain")):
        compare_with_nan(f"edge_factor_gain indefinite (clamped pivot, {part})", got, want)
    # the training path's batches: self-play's E environments (descent,
    # reward, and the commit's S = sym(H P Hᵀ + R) for spd_inverse, as
    # ops/kalman.kf_update builds it) and the arena's G games (descent and
    # edge update)
    for b, commit in ((TRAIN_ENVS, True), (ARENA_GAMES, False)):
        inputs = descent_step_inputs(world, b, gen)
        for got, want, part in zip(kernels.edge_factor_gain(*inputs),
                                   smallchol.edge_factor_gain(*inputs), ("WcT", "gain")):
            compare(f"edge_factor_gain B={b} ({part})", got, want)
        if commit:
            S_raw_b, _, R_b, a_b, _ = inputs
            S_b = S_raw_b + torch.diag_embed(R_b[a_b])
            S_b = (0.5 * (S_b + S_b.mT)).contiguous()
            compare(f"spd_inverse B={b} (a commit's S)", kernels.spd_inverse(S_b),
                    smallchol.spd_inverse(S_b))
    t = times(lambda: kernels.edge_factor_gain(*args), graph_launches=200, calls=200)
    # what bounds it: one CTA (4 missions: one warp's chain and a launch),
    # and the whole batch with one column (the factorisations without Uᵀ·A)
    few = (S_raw[:4], A[:4], R, a[:4], mask[:4])
    t["one_cta_ms"] = graph_ms(lambda: kernels.edge_factor_gain(*few), 200)
    one_col = (S_raw, A[..., :1].contiguous(), R, a, mask[:, :1].contiguous())
    t["one_column_ms"] = graph_ms(lambda: kernels.edge_factor_gain(*one_col), 200)
    previous = times(lambda: previous_edge_tail(*args), graph_launches=50, calls=50)
    plain_ms = cuda_ms(lambda: smallchol.edge_factor_gain(*args), 10)
    lib_ms = cuda_ms(lambda: library_edge_tail(*args), 50)
    elt = A.element_size()
    nbytes = ((S_raw.numel() + 2 * A.numel() + B + B * m + mask.numel()) * elt
              + a.numel() * a.element_size())
    b_ms, b_by = bound(nbytes, B * edge_ops(m, n, masked=True, round_bf16=False))
    log(f"  edge_factor_gain vs the parent's tail (gather, symmetrise, spd_inverse_factor, "
        f"U^T A, sums): {t['ms']:.4f} / {previous['ms']:.4f} ms device, {t['call_ms']:.4f} / "
        f"{previous['call_ms']:.4f} ms per call, host {t['host_ms']:.4f} / "
        f"{previous['host_ms']:.4f} ms; one CTA {t['one_cta_ms']:.4f} ms, one column "
        f"{t['one_column_ms']:.4f} ms device")
    return {
        "name": "edge_factor_gain", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/planners/zero/mcts.py:187",
        "shape": [B, m, n], "dtype": "float32",
        **err, **t, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes": nbytes, "library_ms": lib_ms,
        "library_call": "cholesky(cholesky_inverse(cholesky(S))), U.mT @ A, squares, sum "
                        "(after the symmetrisation)",
        "previous_tail": previous,
    }


def record_trace_products(fn, *args) -> list:
    """The (S, G) inputs of every spd_trace_product launch of fn(*args)."""
    recorded = []
    launch = kernels.spd_trace_product_packed

    def record(S_packed, G_packed):
        recorded.append((S_packed, G_packed))
        return launch(S_packed, G_packed)

    kernels.spd_trace_product_packed = record
    try:
        fn(*args)
    finally:
        kernels.spd_trace_product_packed = launch
    return recorded


def random_waypoints(world, n: int, gen: torch.Generator) -> torch.Tensor:
    """n waypoints uniform over the field's box and altitude band."""
    env, con = world.cfg.environment, world.cfg.constraints
    lo = torch.tensor([0.0, 0.0, con.min_altitude], device="cuda")
    hi = torch.tensor([env.extent_x, env.extent_y, con.max_altitude], device="cuda")
    return lo + torch.rand((n, 3), generator=gen, device="cuda") * (hi - lo)


def continuous_shape_checks(gen: torch.Generator) -> dict:
    """The kernels at the static baselines' and CMA-ES's shapes, bitwise
    against their plain versions: ``spd_inverse`` on a ``step_position``
    commit's S at B = STATIC_B (random waypoints over the box and the
    altitude band: clipped FoVs with padded rows R = 1, rf = 1 and 2);
    ``edge_factor_gain`` on the fitness's inputs at B·λ = CMAES_B · λ and
    one more (per-sample H and R from the continuous model, the adaptive
    mask per member); ``spd_trace_product`` on each launch of one greedy
    sweep at B = CMAES_B (the greedy initialisation's layouts)."""
    out = {}
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    state = world.init_state(STATIC_B, gen)
    wp = random_waypoints(world, STATIC_B, gen)
    H, R, _, valid = world.measurement_model_at(wp)
    check(bool((~valid).any()) and bool((wp[:, 2] > 10).any()) and bool((wp[:, 2] <= 10).any()),
          "the commit's check lacks padded rows or one of the resolution factors")
    A = H @ state.cov
    S = A @ H.mT
    S = (0.5 * (S + S.mT) + torch.diag_embed(R)).contiguous()
    out["spd_inverse"] = compare(f"spd_inverse B={STATIC_B} (a step_position commit's S)",
                                 kernels.spd_inverse(S), smallchol.spd_inverse(S))

    tcfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    tworld = IPPWorld(tcfg)
    lam = tcfg.missions[0].cma_popsize
    tstate = tworld.init_state(CMAES_B + 1, gen)
    scen = tcfg.scenario
    mask = adaptive_mask(tstate.mean, torch.diagonal(tstate.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor)
    errs = []
    for n in (CMAES_B * lam, CMAES_B * lam + 1):
        P = tstate.cov.repeat_interleave(lam, dim=0)[:n]
        m = mask.repeat_interleave(lam, dim=0)[:n]
        Hn, Rn, _, _ = tworld.measurement_model_at(random_waypoints(tworld, n, gen))
        An = Hn @ P
        args = (An @ Hn.mT, An, Rn, torch.arange(n, device="cuda"), m)
        for got, want, part in zip(kernels.edge_factor_gain(*args),
                                   smallchol.edge_factor_gain(*args), ("WcT", "gain")):
            errs.append(compare(f"edge_factor_gain B*lambda={n} per-sample R, mask ({part})",
                                got, want))
        del P, An, args
    out["edge_factor_gain"] = {k: max(e[k] for e in errs) for k in errs[0]}

    recorded = record_trace_products(sweep_rewards, tworld, tworld.init_state(CMAES_B, gen))
    errs = [compare(f"spd_trace_product greedy init {tuple(Sp.shape)}",
                    kernels.spd_trace_product_packed(Sp, Gp),
                    smallchol.spd_trace_product_packed(Sp, Gp)) for Sp, Gp in recorded]
    check(len(recorded) == 2, f"{len(recorded)} trace-product launches in one sweep")
    out["spd_trace_product"] = {k: max(e[k] for e in errs) for k in errs[0]}
    return out


def classic_shape_checks(gen: torch.Generator) -> dict:
    """The kernels at the classic MCTS path's own inputs, bitwise against
    their plain versions: ``spd_trace_product`` on each launch of one sweep
    of R = CLASSIC_B rows with float32 streams (``fast_math=False``, as the
    classic planner sweeps) and per-row adaptive masks (a root mean after
    three commits against its covariance), and ``edge_factor_gain`` on that
    step's edge inputs (the world's H and R tables, the per-row masks)."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    world = IPPWorld(cfg)
    planner = ClassicMCTSPlanner(world, classic_mission())
    state = world.init_state(CLASSIC_B, gen)
    for _ in range(3):
        a = torch.randint(0, world.num_actions, (CLASSIC_B,), generator=gen, device="cuda")
        state = world.step_index(state, a, generator=gen)
    dmask = planner._diag_mask(state.mean, state.cov)
    check(bool((dmask == 0).any()) and not bool((dmask == dmask[:1]).all()),
          "the classic checks' masks are not per-row")
    recorded = record_trace_products(planner._sweep_rewards, state.cov,
                                     planner._costs(state.pos), dmask)
    check(len(recorded) == 2, f"{len(recorded)} trace-product launches in one sweep")
    check(all(Sp.dtype == torch.float32 for Sp, _ in recorded), "the sweep's streams are not f32")
    errs = [compare(f"spd_trace_product classic sweep R={CLASSIC_B} {tuple(Sp.shape)}",
                    kernels.spd_trace_product_packed(Sp, Gp),
                    smallchol.spd_trace_product_packed(Sp, Gp)) for Sp, Gp in recorded]
    out = {"spd_trace_product": {k: max(e[k] for e in errs) for k in errs[0]}}
    a = torch.randint(0, world.num_actions, (CLASSIC_B,), generator=gen, device="cuda")
    H = world.H[a]
    A = H @ state.cov
    args = (A @ H.mT, A, world.R_diag, a, dmask)
    errs = [compare(f"edge_factor_gain classic step R={CLASSIC_B} ({part})", got, want)
            for got, want, part in zip(kernels.edge_factor_gain(*args),
                                       smallchol.edge_factor_gain(*args), ("WcT", "gain"))]
    out["edge_factor_gain"] = {k: max(e[k] for e in errs) for k in errs[0]}
    return out


def large_grid_cfg(dim: int):
    """LARGE_GRID_RAW at a dim x dim grid (the same config family)."""
    raw = copy.deepcopy(LARGE_GRID_RAW)
    raw["environment"]["x_dim"] = raw["environment"]["y_dim"] = dim
    return config_from_dict(raw)


def deploy_shape_checks(gen: torch.Generator) -> dict:
    """The kernels at the deployment and multi-device paths' shapes, bitwise
    against their plain versions.  One mission (B = 1, the deployed loop's
    replans and commits, a GP-prior belief after three commits): each
    ``spd_trace_product`` launch of a greedy sweep (the gather and taps
    groups' (1, 45, 100)), that sweep's ``sweep_tap_blocks`` launch,
    ``spd_inverse`` on a commit's S, ``edge_factor_gain``
    on a zero replan's edge inputs with the adaptive mask.  ``spd_inverse``
    on the large-grid sweep's (A/d, 9, 9) innovations at d = 1 (A = 800 and
    A = 4608) and on the sharded commit's one (9, 9), float32 and float64."""
    errs = {"spd_inverse": [], "spd_trace_product": [], "edge_factor_gain": [],
            "sweep_tap_blocks": []}
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")))
    state = world.init_state(1, gen)
    for _ in range(3):
        step = torch.randint(0, world.num_actions, (1,), generator=gen, device="cuda")
        state = world.step_index(state, step, generator=gen)
    taps, launch_taps = [], kernels.sweep_tap_blocks

    def keep_taps(*args, **kw):
        taps.append((args, kw))
        return launch_taps(*args, **kw)

    kernels.sweep_tap_blocks = keep_taps
    try:
        recorded = record_trace_products(sweep_rewards, world, state)
    finally:
        kernels.sweep_tap_blocks = launch_taps
    shapes = sorted(tuple(Sp.shape) for Sp, _ in recorded)
    check(shapes == [(1, T, ACTIONS_PER_GROUP)] * 2,
          f"the B = 1 sweep's trace-product launches have shapes {shapes}")
    check(len(taps) == 1, f"the B = 1 sweep launched sweep_tap_blocks {len(taps)} times")
    args, kw = taps[0]
    for got, want, part in zip(kernels.sweep_tap_blocks(*args, **kw),
                               smallchol.sweep_tap_blocks(*args, **kw), "SG"):
        errs["sweep_tap_blocks"].append(compare(f"sweep_tap_blocks B=1 ({part})", got, want))
    for Sp, Gp in recorded:
        errs["spd_trace_product"].append(compare(
            f"spd_trace_product B=1 {tuple(Sp.shape)}", kernels.spd_trace_product_packed(Sp, Gp),
            smallchol.spd_trace_product_packed(Sp, Gp)))
    a = torch.randint(0, world.num_actions, (1,), generator=gen, device="cuda")
    H = world.H[a]
    A = H @ state.cov
    S_raw = A @ H.mT
    S = (0.5 * (S_raw + S_raw.mT) + torch.diag_embed(world.R_diag[a])).contiguous()
    errs["spd_inverse"].append(compare("spd_inverse B=1 (a commit's S)", kernels.spd_inverse(S),
                                       smallchol.spd_inverse(S)))
    scen = world.cfg.scenario
    mask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor)
    args = (S_raw, A, world.R_diag, a, mask)
    for got, want, part in zip(kernels.edge_factor_gain(*args), smallchol.edge_factor_gain(*args),
                               ("WcT", "gain")):
        errs["edge_factor_gain"].append(compare(f"edge_factor_gain B=1 ({part})", got, want))
    for dtype in (torch.float32, torch.float64):
        for n in (800, 2 * LARGE_GRID_DIM ** 2):
            S = random_spd(n, gen).to(dtype)
            errs["spd_inverse"].append(compare(
                f"spd_inverse large-grid sweep ({n}, 9, 9) {dtype}", kernels.spd_inverse(S),
                smallchol.spd_inverse(S)))
        S = random_spd(1, gen)[0].to(dtype)
        errs["spd_inverse"].append(compare(f"spd_inverse sharded commit (9, 9) {dtype}",
                                           kernels.spd_inverse(S), smallchol.spd_inverse(S)))
    return {k: {key: max(e[key] for e in v) for key in v[0]} for k, v in errs.items()}


# ------------------------------------------------------------ large-M route

def grid_cfg(grid: dict, name: str = "example.yaml"):
    """The port's copy of config ``name`` on another grid of the same
    field, nothing else changed: FINE_GRID (20 x 20 cells of 2 m: M = 25,
    A = 800, N = 400) or FINE_1M_GRID (40 x 40 cells of 1 m: M = 81 on the
    lattice and 121 in the continuous world, A = 3200, N = 1600)."""
    with open(CONFIG_DIR / name) as f:
        raw = yaml.safe_load(f)
    raw["environment"] = dict(grid)
    return config_from_dict(raw)


def unpacked(Sp: torch.Tensor) -> torch.Tensor:
    """(outer, T, inner) packed lower triangles → (outer * inner, m, m) full
    symmetric blocks (for the library call)."""
    outer, t, inner = Sp.shape
    m = smallchol.packed_m(t)
    flat = Sp.transpose(1, 2).reshape(outer * inner, t)
    full = torch.zeros((outer * inner, m, m), dtype=Sp.dtype, device=Sp.device)
    i, j = torch.tril_indices(m, m, device=Sp.device)
    full[:, i, j] = flat
    full[:, j, i] = flat
    return full


def random_edge_inputs(B: int, m: int, n: int, dtype: torch.dtype, gen: torch.Generator):
    """S_raw = A·Hᵀ, A = H·P (one SPD P), an R table of 7 actions, actions
    and a per-mission 0/1 mask, for an M no world of the repository has."""
    X = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.float64)
    P = X @ X.T / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)
    H = torch.randn((B, m, n), generator=gen, device="cuda", dtype=torch.float64) / n ** 0.5
    A = H @ P
    R = torch.rand((7, m), generator=gen, device="cuda", dtype=torch.float64) + 0.5
    a = torch.randint(0, 7, (B,), generator=gen, device="cuda")
    mask = (torch.rand((B, n), generator=gen, device="cuda") > 0.4).to(dtype)
    return (A @ H.mT).to(dtype), A.to(dtype), R.to(dtype), a, mask


def large_m_rows(gen: torch.Generator) -> dict:
    """The warp route (M = 13..32) bitwise against the plain versions at M
    = 13, 25 and 32 in float32 and float64, then timed at M = 25 on
    FINE_GRID's shapes: ``spd_inverse`` at (4096, M, M) and on a commit's S
    of the fine grid (B = 256), ``spd_trace_product`` on the fine grid's two
    sweep launches at B = 256 ((256, 325, 400) gather, (400, 325, 256)
    dense; random blocks at (256, T, 400) for M = 13 and 32, and a ragged
    (3, T, 33) launch with each kind of kernel), ``spd_inverse_factor`` at
    (1024, M, M), ``edge_factor_gain`` at (1024, M, 400) with a per-mission
    mask (at M = 25 one descent step's inputs on the fine grid).  Then
    ``spd_inverse`` at (4096, M, M) and ``spd_trace_product`` on the sweep
    pair's shapes, at M = 13, 25 and 32, with each kind of
    kernel forced (``kernels.warp_route``: runtime-M, unrolled).  Returns
    per kernel name its checks, its M = 25 times, bound and library call
    (float32), for K1 and K2 the times of both kinds, and for K3 and the
    edge their times at M = 13, 25 and 32 in both dtypes."""
    log("  large-M route: M = 13, 25, 32 in float32 and float64; M = 25 on the "
        f"{FINE_GRID['x_dim']}x{FINE_GRID['y_dim']} grid at resolution {FINE_GRID['resolution']}")
    out = {name: {"checks": []} for name in
           ("spd_inverse", "spd_trace_product", "spd_inverse_factor", "edge_factor_gain")}
    world = IPPWorld(grid_cfg(FINE_GRID), fast_sweeps=True)
    check(world.H.shape[1] == 25 and world.m_max_cont == 25,
          f"the fine grid's M is {world.H.shape[1]} (continuous {world.m_max_cont}), not 25")
    state = world.init_state(FINE_B, gen)
    for _ in range(3):
        step = torch.randint(0, world.num_actions, (FINE_B,), generator=gen, device="cuda")
        state = world.step_index(state, step, generator=gen)
    sweep = record_trace_products(sweep_rewards, world, state)
    shapes = sorted(tuple(Sp.shape) for Sp, _ in sweep)
    check(shapes == [(FINE_B, 325, 400), (400, 325, FINE_B)],
          f"the fine grid's sweep launches have shapes {shapes}")
    commit = descent_step_inputs(world, FINE_B, gen)
    S_commit = commit[0] + torch.diag_embed(commit[2][commit[3]])
    S_commit = (0.5 * (S_commit + S_commit.mT)).contiguous()
    edge25 = descent_step_inputs(world, ZERO_B, gen)

    def record(name, label, got, want):
        out[name]["checks"].append({label: compare(f"{name} {label}", got, want)})

    for m in LARGE_M_CHECKED:
        for dtype in (torch.float32, torch.float64):
            tag = f"M={m} {str(dtype)[6:]}"
            S = random_spd(REPLAN_B, gen, m, dtype)
            record("spd_inverse", f"(4096, {m}, {m}) {tag}", kernels.spd_inverse(S),
                   smallchol.spd_inverse(S))
            S_bad = make_indefinite(random_spd(33, gen, m, dtype))
            record("spd_inverse", f"clamped {tag}", kernels.spd_inverse(S_bad),
                   smallchol.spd_inverse(S_bad))
            S = random_spd(ZERO_B, gen, m, dtype)
            for got, want, part in zip(kernels.spd_inverse_factor(S),
                                       smallchol.spd_inverse_factor(S), ("S^-1", "U")):
                record("spd_inverse_factor", f"(1024, {m}, {m}) {tag} {part}", got, want)
            if m == 25:
                record("spd_inverse", f"a commit's S (256, 25, 25) {tag}",
                       kernels.spd_inverse(S_commit.to(dtype)),
                       smallchol.spd_inverse(S_commit.to(dtype)))
                launches = [(Sp.to(dtype), Gp.to(dtype)) for Sp, Gp in sweep]
                edge = [x.to(dtype) if x.is_floating_point() else x for x in edge25]
            else:
                n = FINE_B * 400
                launches = [(packed(random_spd(n, gen, m, dtype), FINE_B, 400),
                             packed(random_spd(n, gen, m, dtype), FINE_B, 400))]
                edge = random_edge_inputs(ZERO_B, m, 400, dtype, gen)
            for Sp, Gp in launches:
                record("spd_trace_product", f"{tuple(Sp.shape)} {tag}",
                       kernels.spd_trace_product_packed(Sp, Gp),
                       smallchol.spd_trace_product_packed(Sp, Gp))
            Sr = packed(random_spd(99, gen, m, dtype), 3, 33)
            Gr = packed(random_spd(99, gen, m, dtype), 3, 33)
            want = smallchol.spd_trace_product_packed(Sr, Gr)
            for kind in kernels.WARP_ROUTES:
                with kernels.warp_route(kind):
                    got = kernels.spd_trace_product_packed(Sr, Gr)
                record("spd_trace_product", f"ragged (3, T, 33) {tag} {kind}", got, want)
            for got, want, part in zip(kernels.edge_factor_gain(*edge),
                                       smallchol.edge_factor_gain(*edge), ("WcT", "gain")):
                record("edge_factor_gain", f"{tuple(edge[1].shape)} {tag} {part}", got, want)

    # M = 25, float32: device, call and host times, bound, plain and library
    def timed(name, fn, plain, library, nbytes, ops, graph_launches, shape):
        t = times(fn, graph_launches=graph_launches, calls=graph_launches)
        b_ms, b_by = bound(nbytes, ops)
        out[name]["m25"] = {
            "shape": shape, "dtype": "float32", **t,
            "plain_ms": cuda_ms(plain, 2, warmup=1), "library_ms": cuda_ms(library, 5),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
        }

    S = random_spd(REPLAN_B, gen, 25, torch.float32)
    timed("spd_inverse", lambda: kernels.spd_inverse(S), lambda: smallchol.spd_inverse(S),
          lambda: torch.cholesky_inverse(torch.linalg.cholesky(S)), 2 * S.numel() * 4,
          REPLAN_B * inverse_ops(25), 100, list(S.shape))
    fulls = [(unpacked(Sp), unpacked(Gp)) for Sp, Gp in sweep]
    blocks = sum(Sp.shape[0] * Sp.shape[2] for Sp, _ in sweep)
    timed("spd_trace_product",
          lambda: [kernels.spd_trace_product_packed(Sp, Gp) for Sp, Gp in sweep],
          lambda: [smallchol.spd_trace_product_packed(Sp, Gp) for Sp, Gp in sweep],
          lambda: [torch.cholesky_solve(G, torch.linalg.cholesky(S_))
                   .diagonal(dim1=-2, dim2=-1).sum(-1) for S_, G in fulls],
          (2 * 325 + 1) * blocks * 4, blocks * trace_ops(25), 10, [blocks, 325])
    del fulls
    S = random_spd(ZERO_B, gen, 25, torch.float32)
    timed("spd_inverse_factor", lambda: kernels.spd_inverse_factor(S),
          lambda: smallchol.spd_inverse_factor(S),
          lambda: torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(S))),
          3 * S.numel() * 4, ZERO_B * inverse_factor_ops(25), 100, list(S.shape))
    S_raw, A, R, a, mask = edge25
    B, m, n = A.shape
    nbytes = ((S_raw.numel() + 2 * A.numel() + B + B * m + mask.numel()) * 4
              + a.numel() * a.element_size())
    timed("edge_factor_gain", lambda: kernels.edge_factor_gain(*edge25),
          lambda: smallchol.edge_factor_gain(*edge25), lambda: library_edge_tail(*edge25),
          nbytes, B * edge_ops(m, n, masked=True, round_bf16=False), 100, [B, m, n])
    for name, v in out.items():
        t = v["m25"]
        log(f"  {name} M=25 {t['shape']}: kernel {t['ms']:.4f} ms device (graph), "
            f"{t['call_ms']:.4f} ms per call, host {t['host_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of it")
        v["max_abs_err"] = max(e["max_abs_err"] for c in v["checks"] for e in c.values())
    out["spd_inverse"]["kinds"], out["spd_trace_product"]["kinds"] = warp_kind_times(sweep, gen)
    out["spd_inverse_factor"]["warp_m"], out["edge_factor_gain"]["warp_m"] = factor_warp_times(
        edge25, gen)
    return out


def warp_kind_times(sweep: list, gen: torch.Generator) -> tuple:
    """K1 at (4096, M, M) and K2 on the 2 m sweep pair's shapes ((256, T,
    400) + (400, T, 256); at M = 25 the recorded sweep's blocks) with each
    kind of warp-route kernel forced, at M = 13, 25 and 32 in float32
    (device ms, CUDA graph), the bound and one plain and one library call;
    scripts/time_torch_warp_route.py times every M in both dtypes."""
    inv, trace = {}, {}
    for m in LARGE_M_CHECKED:
        S = random_spd(REPLAN_B, gen, m)
        if m == 25:
            pair = sweep
        else:
            n = FINE_B * 400
            pair = [(packed(random_spd(n, gen, m), o, i), packed(random_spd(n, gen, m), o, i))
                    for o, i in ((FINE_B, 400), (400, FINE_B))]
        k1, k2 = {}, {}
        for kind in kernels.WARP_ROUTES:
            with kernels.warp_route(kind):
                k1[kind] = graph_ms(lambda: kernels.spd_inverse(S), 50)
                k2[kind] = graph_ms(
                    lambda: [kernels.spd_trace_product_packed(a, b) for a, b in pair], 4)
        blocks = 2 * FINE_B * 400
        t = smallchol.packed_size(m)
        k1["bound_ms"] = bound(2 * S.numel() * 4, REPLAN_B * inverse_ops(m))[0]
        k2["bound_ms"] = bound((2 * t + 1) * blocks * 4, blocks * trace_ops(m))[0]
        k1["plain_ms"] = plain_once(lambda: smallchol.spd_inverse(S))[1]
        k2["plain_ms"] = plain_once(
            lambda: [smallchol.spd_trace_product_packed(a, b) for a, b in pair])[1]
        k1["library_ms"] = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(S)), 5)
        fulls = [(unpacked(a), unpacked(b)) for a, b in pair]
        k2["library_ms"] = cuda_ms(
            lambda: [torch.cholesky_solve(G, torch.linalg.cholesky(S_))
                     .diagonal(dim1=-2, dim2=-1).sum(-1) for S_, G in fulls], 2)
        del fulls, pair
        tag = f"M={m} float32"
        inv[tag], trace[tag] = k1, k2
        for name, k in (("spd_inverse (4096, M, M)", k1), ("spd_trace_product pair", k2)):
            log(f"  {name} {tag}: runtime-M {k['runtime_m']:.4f} ms, unrolled "
                f"{k['unrolled']:.4f} ms device; bound {k['bound_ms']:.4f}, plain "
                f"{k['plain_ms']:.1f}, library {k['library_ms']:.3f} ms")
    return inv, trace


def edge_bytes(S_raw, A, R, a, mask) -> int:
    """Bytes edge_factor_gain must move: S_raw and A read, Wcᵀ and the gain
    written, the mask, one R row and one action per mission."""
    B, m, _ = A.shape
    return ((S_raw.numel() + 2 * A.numel() + B + B * m + (0 if mask is None else mask.numel()))
            * A.element_size() + a.numel() * a.element_size())


def factor_warp_times(edge25, gen: torch.Generator) -> tuple:
    """K3 at (1024, M, M) and edge_factor_gain at (1024, M, 400) with a
    per-mission mask (at M = 25 one 2 m descent step's inputs) at M = 13,
    25 and 32 in float32 and float64: device ms (CUDA graph), the bound,
    one plain and one library call, and the edge's kernels by the
    profiler; scripts/time_torch_warp_route.py times every M."""
    fac, edge = {}, {}
    for dtype in (torch.float32, torch.float64):
        elt = torch.finfo(dtype).bits // 8
        for m in LARGE_M_CHECKED:
            S = random_spd(ZERO_B, gen, m, dtype)
            if m == 25:
                args = tuple(x.to(dtype) if x.is_floating_point() else x for x in edge25)
            else:
                args = random_edge_inputs(ZERO_B, m, 400, dtype, gen)
            B, _, n = args[1].shape
            k3 = {"ms": graph_ms(lambda: kernels.spd_inverse_factor(S), 50)}
            ke = {"ms": graph_ms(lambda: kernels.edge_factor_gain(*args), 50)}
            k3["bound_ms"], k3["bound_by"] = bound(3 * S.numel() * elt,
                                                   ZERO_B * inverse_factor_ops(m))
            ke["bound_ms"], ke["bound_by"] = bound(
                edge_bytes(*args), B * edge_ops(m, n, masked=True, round_bf16=False))
            k3["plain_ms"] = plain_once(lambda: smallchol.spd_inverse_factor(S))[1]
            ke["plain_ms"] = plain_once(lambda: smallchol.edge_factor_gain(*args))[1]
            k3["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(
                torch.cholesky_inverse(torch.linalg.cholesky(S))), 5)
            ke["library_ms"] = cuda_ms(lambda: library_edge_tail(*args), 5)
            ke["kernels_us"] = device_kernels_us(lambda: kernels.edge_factor_gain(*args))
            tag = f"M={m} {str(dtype)[6:]}"
            fac[tag], edge[tag] = k3, ke
            for name, k in ((f"spd_inverse_factor (1024, {m}, {m})", k3),
                            (f"edge_factor_gain (1024, {m}, 400)", ke)):
                log(f"  {name} {tag}: {k['ms']:.4f} ms device; bound {k['bound_ms']:.4f} "
                    f"({k['bound_by']}), plain {k['plain_ms']:.1f}, library "
                    f"{k['library_ms']:.3f} ms")
            log(f"    the edge's kernels (profiler, µs): {ke['kernels_us']}")
            del args
    return fac, edge


def plain_once(fn):
    """(output, device ms) of one call of a plain version: at M = 81 and 121
    one call is seconds of small launches."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def fine_1m_world():
    """example.yaml on FINE_1M_GRID with fast sweeps, and the host seconds
    its tables took (numpy, as in the JAX package)."""
    t = time.perf_counter()
    world = IPPWorld(grid_cfg(FINE_1M_GRID), fast_sweeps=True)
    built_s = time.perf_counter() - t
    check(world.H.shape[1] == 81 and world.m_max_cont == 121 and world.num_actions == 3200,
          f"the 1 m grid's M is {world.H.shape[1]} (continuous {world.m_max_cont}), "
          f"A = {world.num_actions}, not 81 (121), 3200")
    return world, built_s


def cta_m_rows(gen: torch.Generator) -> dict:
    """The CTA route (M >= 33, one CTA per matrix) at the 1 m grid's shapes,
    float32, timed and held bitwise against the plain versions on the timed
    inputs: ``spd_inverse`` at (4096, 81, 81) and (4096, 121, 121),
    ``spd_trace_product`` on the 1 m sweep's two launches at B = FINE_1M_B
    ((16, 3321, 1600) gather, (1600, 3321, 16) dense), ``spd_inverse_factor``
    at (1024, 81, 81), ``edge_factor_gain`` at (192, 121, 1600) as CMA-ES's
    fitness forms it (B·λ = 16 x 12 members, H and R of random waypoints
    from the continuous model, a per-member mask).  Then, at M =
    CTA_M_CHECKED, clamped pivots (inf and NaN where the plain versions
    have them) and float64 with the workspace in global memory; at M =
    CTA_M_RAGGED, ragged runs of blocks and a ragged column tile.  Returns
    per kernel name its rows and checks."""
    log(f"  CTA route: M = 81 and 121 on the {FINE_1M_GRID['x_dim']}x{FINE_1M_GRID['y_dim']} "
        f"grid at resolution {FINE_1M_GRID['resolution']}; clamped and float64 (global "
        f"workspace) at M = {CTA_M_CHECKED}; ragged at M = {CTA_M_RAGGED}")
    out = {name: {"rows": [], "checks": []} for name in
           ("spd_inverse", "spd_trace_product", "spd_inverse_factor", "edge_factor_gain")}
    world, built_s = fine_1m_world()
    log(f"  the 1 m world's tables took {built_s:.1f} s on the host")
    state = world.init_state(FINE_1M_B, gen)
    for _ in range(3):
        step = torch.randint(0, world.num_actions, (FINE_1M_B,), generator=gen, device="cuda")
        state = world.step_index(state, step, generator=gen)
    sweep = record_trace_products(sweep_rewards, world, state)
    shapes = sorted(tuple(Sp.shape) for Sp, _ in sweep)
    check(shapes == [(FINE_1M_B, 3321, 1600), (1600, 3321, FINE_1M_B)],
          f"the 1 m grid's sweep launches have shapes {shapes}")
    lam = 12
    P = state.cov.repeat_interleave(lam, dim=0)
    scen = world.cfg.scenario
    mask = adaptive_mask(state.mean, torch.diagonal(state.cov, dim1=-2, dim2=-1),
                         scen.value_threshold, scen.interval_factor).repeat_interleave(lam, dim=0)
    H, R, _, _ = world.measurement_model_at(random_waypoints(world, FINE_1M_B * lam, gen))
    A = H @ P
    edge = (A @ H.mT, A, R.contiguous(), torch.arange(len(A), device="cuda"), mask.contiguous())
    del P, H, world, state
    torch.cuda.empty_cache()

    def row(name, label, fn, plain, library, nbytes, ops, graph_launches, shape):
        want, plain_ms = plain_once(plain)
        got = fn()
        want, got = (x if isinstance(x, (list, tuple)) else [x] for x in (want, got))
        errs = [compare(f"{name} {label}", g, w) for g, w in zip(got, want)]
        del got, want
        t = times(fn, graph_launches=graph_launches, calls=graph_launches)
        b_ms, b_by = bound(nbytes, ops)
        r = {"label": label, "shape": shape, "dtype": "float32", **t, "plain_ms": plain_ms,
             "library_ms": cuda_ms(library, 3, warmup=1), "bound_ms": b_ms, "bound_by": b_by,
             "bound_bytes": nbytes, "max_abs_err": max(e["max_abs_err"] for e in errs)}
        out[name]["rows"].append(r)
        log(f"  {name} {label} {shape}: kernel {r['ms']:.4f} ms device (graph), "
            f"{r['call_ms']:.4f} ms per call, host {r['host_ms']:.4f} ms; plain "
            f"{plain_ms:.1f} ms, library {r['library_ms']:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / r['ms']:.1%} of it")

    for m in (81, 121):
        S = random_spd(REPLAN_B, gen, m)
        row("spd_inverse", f"M={m}", lambda: kernels.spd_inverse(S),
            lambda: smallchol.spd_inverse(S),
            lambda: torch.cholesky_inverse(torch.linalg.cholesky(S)), 2 * S.numel() * 4,
            REPLAN_B * inverse_ops(m), 10, list(S.shape))
    del S
    fulls = [(unpacked(Sp), unpacked(Gp)) for Sp, Gp in sweep]
    blocks = sum(Sp.shape[0] * Sp.shape[2] for Sp, _ in sweep)
    row("spd_trace_product", "M=81 the 1 m sweep",
        lambda: [kernels.spd_trace_product_packed(Sp, Gp) for Sp, Gp in sweep],
        lambda: [smallchol.spd_trace_product_packed(Sp, Gp) for Sp, Gp in sweep],
        lambda: [torch.cholesky_solve(G, torch.linalg.cholesky(S_))
                 .diagonal(dim1=-2, dim2=-1).sum(-1) for S_, G in fulls],
        (2 * 3321 + 1) * blocks * 4, blocks * trace_ops(81), 5, [blocks, 3321])
    del fulls, sweep
    S = random_spd(ZERO_B, gen, 81)
    row("spd_inverse_factor", "M=81", lambda: kernels.spd_inverse_factor(S),
        lambda: smallchol.spd_inverse_factor(S),
        lambda: torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(S))),
        3 * S.numel() * 4, ZERO_B * inverse_factor_ops(81), 10, list(S.shape))
    S_raw, A, R, a, mask = edge
    B, m, n = A.shape
    nbytes = ((S_raw.numel() + 2 * A.numel() + B + B * m + mask.numel()) * 4
              + a.numel() * a.element_size())
    row("edge_factor_gain", "M=121 CMA-ES's fitness", lambda: kernels.edge_factor_gain(*edge),
        lambda: smallchol.edge_factor_gain(*edge), lambda: library_edge_tail(*edge),
        nbytes, B * edge_ops(m, n, masked=True, round_bf16=False), 10, [B, m, n])
    del edge, S_raw, A, R, a, mask

    # clamped pivots, and float64 with the workspace in global memory
    m = CTA_M_CHECKED

    def record(name, label, got, want, nan=False):
        parts = {"spd_inverse_factor": ("S^-1", "U"), "edge_factor_gain": ("WcT", "gain")}
        for g, w, part in zip(got, want, parts.get(name, ("",))):
            tag = f"{name} M={m} {label} {part}".rstrip()
            if nan:
                compare_with_nan(tag, g, w)
                out[name]["checks"].append({tag: "bitwise or both NaN"})
            else:
                out[name]["checks"].append({tag: compare(tag, g, w)})

    S_bad = make_indefinite(random_spd(33, gen, m))
    record("spd_inverse", "clamped", [kernels.spd_inverse(S_bad)], [smallchol.spd_inverse(S_bad)])
    record("spd_inverse_factor", "clamped", kernels.spd_inverse_factor(S_bad),
           smallchol.spd_inverse_factor(S_bad), nan=True)
    Sp = packed(make_indefinite(random_spd(2 * 7, gen, m)), 2, 7)
    Gp = packed(random_spd(2 * 7, gen, m), 2, 7)
    record("spd_trace_product", "clamped (2, T, 7)", [kernels.spd_trace_product_packed(Sp, Gp)],
           [smallchol.spd_trace_product_packed(Sp, Gp)])
    bad = list(random_edge_inputs(9, m, 100, torch.float32, gen))
    bad[0] = make_indefinite(bad[0])
    record("edge_factor_gain", "clamped (9, M, 100)", kernels.edge_factor_gain(*bad),
           smallchol.edge_factor_gain(*bad), nan=True)
    S = random_spd(33, gen, m, torch.float64)
    Sp, Gp = packed(S[:30], 5, 6), packed(random_spd(30, gen, m, torch.float64), 5, 6)
    e64 = random_edge_inputs(9, m, 100, torch.float64, gen)
    want = (smallchol.spd_inverse(S), smallchol.spd_inverse_factor(S),
            smallchol.spd_trace_product_packed(Sp, Gp), smallchol.edge_factor_gain(*e64))
    with kernels.cta_workspace_in_global_memory():
        got = (kernels.spd_inverse(S), kernels.spd_inverse_factor(S),
               kernels.spd_trace_product_packed(Sp, Gp), kernels.edge_factor_gain(*e64))
    record("spd_inverse", "float64 global workspace", [got[0]], [want[0]])
    record("spd_inverse_factor", "float64 global workspace", got[1], want[1])
    record("spd_trace_product", "float64 global workspace", [got[2]], [want[2]])
    record("edge_factor_gain", "float64 global workspace", got[3], want[3])
    # ragged: a trace-product CTA with one block for its two slots, and with
    # blocks across two o; Uᵀ·A with 37 of a 64-column tile, a shared (N,) mask and
    # the bf16 round trip (M = CTA_M_RAGGED: a plain call is ~0.5 s there)
    m = CTA_M_RAGGED
    for outer, inner in ((1, 1), (3, 11)):
        Sp = packed(make_indefinite(random_spd(outer * inner, gen, m)), outer, inner)
        Gp = packed(random_spd(outer * inner, gen, m), outer, inner)
        record("spd_trace_product", f"ragged ({outer}, T, {inner})",
               [kernels.spd_trace_product_packed(Sp, Gp)],
               [smallchol.spd_trace_product_packed(Sp, Gp)])
    e = random_edge_inputs(5, m, 37, torch.float32, gen)
    e = (*e[:4], e[4][0].contiguous(), True)
    record("edge_factor_gain", "ragged (5, M, 37), (N,) mask, bf16", kernels.edge_factor_gain(*e),
           smallchol.edge_factor_gain(*e))
    for v in out.values():
        v["max_abs_err"] = max([r["max_abs_err"] for r in v["rows"]]
                               + [e["max_abs_err"] for c in v["checks"] for e in c.values()
                                  if isinstance(e, dict)])
    return out


# ------------------------------------------------------------ greedy slice

KERNEL_WRAPPERS = ("spd_inverse", "spd_inverse_factor", "spd_trace_product_packed",
                   "edge_factor_gain", "sweep_tap_blocks")


@contextlib.contextmanager
def plain_versions():
    """Route the sweep, the commit and the edge update through the plain
    versions (for the comparison only; the port itself has no such
    switch)."""
    saved = {attr: getattr(kernels, attr) for attr in KERNEL_WRAPPERS}
    for attr in KERNEL_WRAPPERS:
        setattr(kernels, attr, getattr(smallchol, attr))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(kernels, attr, fn)


#: the counter of the sweep's two-stage contraction (ops/kalman._dense_group_gains)
TWO_STAGE = "sweep.dense_two_stage"


def two_stage_calls() -> int:
    """The sweep's two-stage contraction's calls since the counter's reset."""
    return tracing.counts(TWO_STAGE).get(TWO_STAGE, 0)


def greedy_phase(cfg) -> dict:
    log(f"== greedy slice: example.yaml, fast_sweeps, B={REPLAN_B}, {REPLAN_STEPS} steps")
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    planner.run(REPLAN_B, max_steps=1, generator=gen)  # warm-up: handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    tracing.reset(counters=TWO_STAGE)
    t0 = time.perf_counter()
    res = planner.run(REPLAN_B, max_steps=REPLAN_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, two_stage = kernels.launch_counts(), two_stage_calls()
    log(f"  launches in the run: {launches}; two-stage sweeps {two_stage}")
    for name in ("spd_inverse", "spd_trace_product"):
        check(launches[name] > 0, f"{name} was not launched on the greedy path")
    check(launches["sweep_tap_blocks"] == REPLAN_STEPS and two_stage == 0,
          "the greedy sweeps did not take the tap kernel once a step")

    unc = res.metrics["uncertainty"]
    check(unc.shape == (REPLAN_B, REPLAN_STEPS + 1), f"uncertainty shape {unc.shape}")
    # wrmse and wmll keep the reference's weighting, which can go negative
    # under a square root or log (NaN); the JAX package gives the same
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"metric {k} not finite")
    mean_unc = unc.mean(axis=0)
    log(f"  mean uncertainty per step: {np.array2string(mean_unc, precision=3)}")
    check(bool(np.all(np.diff(mean_unc) < 0)), "uncertainty does not fall step over step")

    # steady replan step, split into sweep (plan) and commit (step_index)
    state = res.final_state
    action = planner.plan(state, gen, 0)
    plan_ms = cuda_ms(lambda: planner.plan(state, gen, 0), 5)
    commit_ms = cuda_ms(lambda: world.step_index(state, action, generator=gen), 5)
    out = {
        "batch": REPLAN_B, "steps": REPLAN_STEPS,
        "run_wall_s": wall,
        "ms_per_step": wall / REPLAN_STEPS * 1e3,
        "replans_per_s": REPLAN_B * REPLAN_STEPS / wall,
        "plan_ms": plan_ms, "commit_ms": commit_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mean_uncertainty": mean_unc.tolist(),
        "launches": launches, "two_stage_calls": two_stage,
    }
    log(f"  run: {out['ms_per_step']:.3f} ms/step, {out['replans_per_s']:.1f} replans/s; "
        f"plan {plan_ms:.3f} ms, commit {commit_ms:.3f} ms; "
        f"peak {out['peak_mem_gb']:.2f} GB")
    return out


def agreement_phase(cfg) -> dict:
    log(f"== kernels vs plain versions on the slice: B={AGREE_B}, {AGREE_STEPS} steps")
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    state0 = world.init_state(AGREE_B, gen)
    noise = torch.randn((AGREE_STEPS, AGREE_B, world.H.shape[1]), generator=gen, device="cuda")
    with_kernels = planner.run(AGREE_B, AGREE_STEPS, init_state=state0, noise=noise)
    with plain_versions():
        plain = planner.run(AGREE_B, AGREE_STEPS, init_state=state0, noise=noise)
    same = np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True)
    check(same, "the kernels and the plain versions chose different actions")
    worst = 0.0
    for k, v in plain.metrics.items():
        got = with_kernels.metrics[k]
        check(np.array_equal(np.isnan(got), np.isnan(v)), f"metric {k}: NaN patterns differ")
        rel = np.nanmax(np.abs(got - v)) / max(np.nanmax(np.abs(v)), 1e-30)
        worst = max(worst, float(rel))
    log(f"  actions identical; worst metric rel diff {worst:.3e} (tolerance {METRIC_RTOL:g})")
    check(worst <= METRIC_RTOL, "metric curves differ between kernels and plain versions")
    return {"batch": AGREE_B, "steps": AGREE_STEPS, "actions_identical": True,
            "worst_metric_rel_diff": worst}


# ------------------------------------------------------------ MCTS-zero slice

class RootVisits:
    """Records the root visit counts of every search a planner runs (a
    wrapper around its ``mcts.search``, in this script only)."""

    def __init__(self, planner):
        self.Ns, self.Nsa = [], []
        search = planner.mcts.search

        def recorded(*args, **kw):
            tree, mask = search(*args, **kw)
            self.Ns.append(tree.Ns[:, 0].clone())
            self.Nsa.append(tree.Nsa[:, 0].clone())
            return tree, mask

        planner.mcts.search = recorded


@contextlib.contextmanager
def traced():
    """The program's tracer on, from empty, while the block runs; the list
    it yields receives the tracer's snapshot (its spans, each with its
    device ms between CUDA events, and its counters) when the block ends."""
    tracing.reset()
    tracing.enable()
    out = []
    try:
        yield out
    finally:
        tracing.disable()
    out.append(tracing.snapshot())


def span_ms(snap, name: str, inside: str | None = None) -> list:
    """Device ms of each span ``name`` of a snapshot, in the order they
    opened; with ``inside``, of those opened inside a span of that name."""
    by_id = {s.id: s for s in snap.spans}

    def under(s):
        p = by_id.get(s.parent)
        while p is not None and p.name != inside:
            p = by_id.get(p.parent)
        return p is not None

    return [s.device_ms for s in snap.spans if s.name == name and (inside is None or under(s))]


def span_count(snap, name: str) -> int:
    return sum(s.name == name for s in snap.spans)


def network_flops(net, planes: torch.Tensor, mask: torch.Tensor) -> int:
    """Multiply-adds × 2 of the convolutions and dense layers of one
    forward over ``planes``, counted from their output shapes by hooks."""
    total = 0

    def count(module, inputs, out):
        nonlocal total
        w = module.weight
        per_output = w[0].numel() if isinstance(module, torch.nn.Conv2d) else w.shape[1]
        total += 2 * out.numel() * per_output

    layers = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    hooks = [m.register_forward_hook(count) for m in layers]
    try:
        with torch.no_grad():
            net(planes, mask)
    finally:
        for h in hooks:
            h.remove()
    return total


def zero_mission(cfg, **hp_changes):
    mc = cfg.missions[0]
    check(mc.type == "mcts_zero", "example.yaml's first mission is not mcts_zero")
    return dataclasses.replace(mc, hyper_params=dataclasses.replace(mc.hyper_params,
                                                                    **hp_changes))


def zero_phase(cfg) -> dict:
    mc = zero_mission(cfg)
    hp = mc.hyper_params
    sims = hp.num_mcts_simulations
    log(f"== MCTS-zero slice: example.yaml mission 0, {hp.num_channels} channels, "
        f"{hp.num_encoder_res_blocks} encoder blocks, {sims} simulations, horizon "
        f"{mc.episode_horizon}, B={ZERO_B}, {ZERO_STEPS} replan steps")
    world = IPPWorld(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    net = init_network(cfg, hp, gen)
    predict = predict_fn(net, dtype=inference_dtype(hp))
    log(f"  network: {sum(p.numel() for p in net.parameters())} parameters, seeded init "
        f"{time.perf_counter() - t0:.2f} s, inference dtype {inference_dtype(hp) or 'float32'}")
    # warm-up at the run's shapes with 2 simulations: cuDNN handles, allocator
    ZeroPlanner(world, zero_mission(cfg, num_mcts_simulations=2), predict,
                net.state_dict()).run(ZERO_B, max_steps=1, generator=gen)
    planner = ZeroPlanner(world, mc, predict, net.state_dict(), deploy_mode="reference")
    visits = RootVisits(planner)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    before = tracing.counts("zero.")
    t0 = time.perf_counter()
    res = planner.run(ZERO_B, max_steps=ZERO_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    steps = tracing.counts("zero.")["zero.descent_steps"] - before.get("zero.descent_steps", 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches in the run: {launches}; descent steps {steps}")
    for name in ("spd_inverse", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched on the zero path")
    check(launches["edge_factor_gain"] == steps,
          "edge_factor_gain did not launch once per descent step")
    check(launches["spd_inverse_factor"] == 0, "spd_inverse_factor launched on the zero path")

    check(len(visits.Ns) == ZERO_STEPS, f"{len(visits.Ns)} searches for {ZERO_STEPS} replans")
    root_ns = torch.stack(visits.Ns)  # (steps, B)
    log(f"  root visit totals: min {root_ns.min().item():g}, max {root_ns.max().item():g} "
        f"(want {sims - 1} for every mission at every replan)")
    check(bool((root_ns == sims - 1).all()), "a root's visit total is not simulations - 1")
    unc = res.metrics["uncertainty"]
    check(unc.shape == (ZERO_B, ZERO_STEPS + 1), f"uncertainty shape {unc.shape}")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"metric {k} not finite")
    mean_unc = unc.mean(axis=0)
    log(f"  mean uncertainty per step: {np.array2string(mean_unc, precision=3)}")
    check(bool(np.all(np.diff(mean_unc) < 0)), "uncertainty does not fall step over step")

    # one more steady replan, split into phases by the program's spans
    state = res.final_state
    hist = init_history(cfg, hp, ZERO_B, world.dtype, world.device)
    hist = push_history(hist, state.cov, state.pos, state.budget / cfg.constraints.budget)
    with traced() as snap:
        planner._replan(state, hist, gen, None)
    split = zero_split(snap[0])
    n = cfg.environment.num_cells
    flops = network_flops(net, torch.zeros((ZERO_B, n, n, plane_channels(hp)), device=world.device),
                          torch.ones((ZERO_B, world.num_actions), device=world.device))
    forwards = span_count(snap[0], "zero.forward")
    tflops = flops / (split["forward"] / forwards * 1e-3) / 1e12
    log(f"  network forward: {flops / 1e12:.3f} TFLOP per simulation at B={ZERO_B}, "
        f"{forwards} forwards, {split['forward'] / forwards:.2f} ms each, {tflops:.1f} TFLOP/s")

    out = {
        "batch": ZERO_B, "steps": ZERO_STEPS, "simulations": sims,
        "channels": hp.num_channels, "encoder_blocks": hp.num_encoder_res_blocks,
        "run_wall_s": wall,
        "ms_per_step": wall / ZERO_STEPS * 1e3,
        "replans_per_s": ZERO_B * ZERO_STEPS / wall,
        "ms_per_mission_replan": wall / (ZERO_B * ZERO_STEPS) * 1e3,
        "peak_mem_gb": peak,
        "root_visits": [root_ns.min().item(), root_ns.max().item()],
        "mean_uncertainty": mean_unc.tolist(),
        "launches": launches,
        "launches_per_replan": {k: v / ZERO_STEPS for k, v in launches.items()},
        "descent_steps": steps,
        "replan_split_ms": split,
        "forward_flops": flops, "forward_ms": split["forward"] / forwards,
        "forward_tflops_per_s": tflops,
    }
    log(f"  run: {out['ms_per_step']:.1f} ms per replan step, {out['replans_per_s']:.1f} "
        f"replans/s, {out['ms_per_mission_replan']:.3f} ms per mission-replan; "
        f"peak {peak:.2f} GB")
    return out


#: chip_smoke's phases of a zero replan, by the program's spans
ZERO_PHASES = {"descent": "zero.descent", "leaf_planes": "zero.leaf", "forward": "zero.forward",
               "integrate_backup": "zero.backup", "replan": "zero.replan"}


def zero_split(snap) -> dict:
    """ms per phase of the replans a snapshot holds, by CUDA events."""
    split = {k: sum(span_ms(snap, name)) for k, name in ZERO_PHASES.items()}
    split["other"] = split["replan"] - sum(v for k, v in split.items() if k != "replan")
    log("  replan by CUDA events: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
    return split


def zero_agreement_phase(cfg) -> dict:
    log(f"== kernels vs plain versions on the zero slice: committed checkpoint, clean, "
        f"B={ZERO_AGREE_B}, {ZERO_AGREE_STEPS} steps, deterministic algorithms")
    mc = zero_mission(cfg, **CHECKPOINT_HP)
    world = IPPWorld(cfg)
    net = load_checkpoint(str(CHECKPOINT), init_network(cfg, mc.hyper_params,
                                                       torch.Generator(device="cuda")))
    planner = ZeroPlanner(world, mc, predict_fn(net), net.state_dict(), deploy_mode="clean")
    visits = RootVisits(planner)
    gen = torch.Generator(device="cuda").manual_seed(2)
    state0 = world.init_state(ZERO_AGREE_B, gen)
    noise = torch.randn((ZERO_AGREE_STEPS, ZERO_AGREE_B, world.H.shape[1]), generator=gen,
                        device="cuda")
    torch.backends.cudnn.benchmark = False
    # deterministic cuBLAS asks for this workspace setting, read at each call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def run():
            return planner.run(ZERO_AGREE_B, ZERO_AGREE_STEPS, init_state=state0, noise=noise,
                               generator=torch.Generator(device="cuda").manual_seed(3))

        kernels.reset_launch_counts()
        with_kernels = run()
        launches = kernels.launch_counts()
        with plain_versions():
            plain = run()
        check(kernels.launch_counts() == launches, "a kernel launched under plain_versions()")
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("spd_inverse", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched in the agreement run")
    same = np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True)
    check(same, "the kernels and the plain versions chose different actions")
    k_visits, p_visits = visits.Nsa[:ZERO_AGREE_STEPS], visits.Nsa[ZERO_AGREE_STEPS:]
    check(all(torch.equal(a, b) for a, b in zip(k_visits, p_visits)),
          "root visit counts differ between kernels and plain versions")
    check(all(bool((n == mc.hyper_params.num_mcts_simulations - 1).all()) for n in visits.Ns),
          "a root's visit total is not simulations - 1")
    worst = 0.0
    for k, v in plain.metrics.items():
        got = with_kernels.metrics[k]
        check(np.array_equal(np.isnan(got), np.isnan(v)), f"metric {k}: NaN patterns differ")
        rel = np.nanmax(np.abs(got - v)) / max(np.nanmax(np.abs(v)), 1e-30)
        worst = max(worst, float(rel))
    unc = with_kernels.metrics["uncertainty"].mean(axis=0)
    log(f"  actions and root visits identical; worst metric rel diff {worst:.3e} "
        f"(tolerance {METRIC_RTOL:g}); launches with kernels {launches}; mean uncertainty "
        f"{np.array2string(unc, precision=3)}")
    check(worst <= METRIC_RTOL, "metric curves differ between kernels and plain versions")
    return {"batch": ZERO_AGREE_B, "steps": ZERO_AGREE_STEPS, "actions_identical": True,
            "root_visits_identical": True, "worst_metric_rel_diff": worst,
            "launches": launches, "mean_uncertainty": unc.tolist()}


# ------------------------------------------------------------ MCTS-zero training

class PartMeter:
    """Peak device memory and host seconds (synchronised before and after)
    of each call of wrapped methods, by part."""

    def __init__(self):
        self.gb, self.seconds = {}, {}

    def wrap(self, obj, attr: str, part: str) -> None:
        fn = getattr(obj, attr)

        def measured(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds.setdefault(part, []).append(time.perf_counter() - t0)
            self.gb[part] = max(self.gb.get(part, 0.0), torch.cuda.max_memory_allocated() / 1e9)
            return out

        setattr(obj, attr, measured)


def share_changed(before: dict, after: dict, suffix: str) -> float:
    """The share of the state dict's tensors named ``*suffix`` that moved."""
    names = [k for k in before if k.endswith(suffix)]
    return sum(not torch.equal(before[k], after[k]) for k in names) / max(len(names), 1)


def train_step_timing(learner, hp, cfg) -> dict:
    """LOSS_STEPS train steps at LOSS_LR on one fixed batch of the phase's
    replay window, on a copy of the learner's state with a fresh optimiser:
    the loss's excess over its floor (the cross-entropy cannot go below
    the target policies' entropy) must fall; the steps are timed by CUDA
    events."""
    state = reset_optimizer(hp, load_checkpoint(learner.deployment_path(), learner.state))
    win, slots = learner.replay.device_window(hp.max_train_examples_history)
    rows = learner.replay.epoch_rows(1, hp.batch_size, np.random.default_rng(0), slots)[0]
    batch = learner.replay._gather_device(win, torch.as_tensor(rows, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = batch.policy
    floor = torch.mean(-torch.sum(torch.where(p > 0, p * torch.log(p), 0.0), dim=-1)).item()
    losses, norms = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    state, m, _ = learner.train_step(state, batch, gen, LOSS_LR)  # warm-up, and the first loss
    losses.append(m["total_loss"])
    start.record()
    for _ in range(LOSS_STEPS - 1):
        state, m, _ = learner.train_step(state, batch, gen, LOSS_LR)
        losses.append(m["total_loss"])
        norms.append(m["grad_norm"])
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (LOSS_STEPS - 1)
    losses = [x.item() for x in losses]
    n = cfg.environment.num_cells
    flops = network_flops(learner.net, torch.zeros((hp.batch_size, n, n, plane_channels(hp)),
                                                   device="cuda"),
                          torch.ones((hp.batch_size, learner.world.num_actions), device="cuda"))
    out = {
        "loss_steps": LOSS_STEPS, "loss_lr": LOSS_LR, "loss_first": losses[0],
        "loss_last": losses[-1], "loss_floor": floor,
        "loss_ratio": (losses[-1] - floor) / (losses[0] - floor),
        "train_step_ms": step_ms, "samples_per_s": hp.batch_size / (step_ms * 1e-3),
        "forward_flops": flops, "train_tflops_per_s": 3 * flops / (step_ms * 1e-3) / 1e12,
    }
    log(f"  fixed batch: {LOSS_STEPS} steps at lr {LOSS_LR:g}: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over the target entropy {floor:.4f}: excess ratio "
        f"{out['loss_ratio']:.3f} (must be < {LOSS_RATIO})")
    check(all(np.isfinite(losses)) and all(bool(torch.isfinite(x)) for x in norms),
          "fixed-batch losses or gradient norms not finite")
    check(out["loss_ratio"] < LOSS_RATIO, "training on a fixed batch did not lower its loss")
    log(f"  train step (B={hp.batch_size}): {step_ms:.2f} ms by CUDA events, "
        f"{out['samples_per_s']:.0f} samples/s; forward {flops / 1e12:.4f} TFLOP, forward + "
        f"backward counted as 3x: {out['train_tflops_per_s']:.1f} TFLOP/s")
    return out


def training_phase(cfg) -> dict:
    mc = zero_mission(cfg, max_episode_steps=TRAIN_EPISODE_STEPS)
    hp = mc.hyper_params
    sims = hp.num_mcts_simulations
    log(f"== MCTS-zero training: example.yaml mission 0, {hp.num_channels} channels, "
        f"{hp.num_encoder_res_blocks} encoder blocks, {sims} simulations, horizon "
        f"{mc.episode_horizon}, batch {hp.batch_size}, {hp.num_epochs} epochs, "
        f"{'PER' if hp.use_per else 'uniform'} replay, dropout {hp.dropout}; cut to "
        f"{TRAIN_ENVS} envs x {TRAIN_EPISODE_STEPS} steps, {TRAIN_ITERATIONS} iterations")
    check(not hp.use_per and hp.continuous_network_update and hp.dropout == 0.0,
          "mission 0 is not uniform replay, continuous update, dropout 0")
    world = IPPWorld(cfg)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        learner = ZeroLearner(world, mc, checkpoints_dir=os.path.join(tmp, "ckpt"),
                              log_dir=os.path.join(tmp, "logs"), num_envs=TRAIN_ENVS, seed=0)
        before = {k: v.clone() for k, v in learner.state.variables().items()}
        visits = RootVisits(learner)
        meter = PartMeter()
        meter.wrap(learner.selfplay, "run", "selfplay")
        meter.wrap(learner, "train_iteration", "train")
        torch.cuda.synchronize()
        # the self-play searches split by the program's spans, as phase 5 splits a replan
        with traced() as snap:
            t0 = time.perf_counter()
            learner.learn(num_iterations=TRAIN_ITERATIONS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
        snap = snap[0]
        split = {k: sum(span_ms(snap, name)) for k, name in ZERO_PHASES.items() if k != "replan"}
        split["selfplay"] = sum(span_ms(snap, "zero.selfplay"))
        split["train"] = sum(span_ms(snap, "zero.train"))
        split["selfplay_other"] = split["selfplay"] - sum(
            split[k] for k in ("descent", "leaf_planes", "forward", "integrate_backup"))
        selfplay_steps = len(span_ms(snap, "plan.commit", inside="zero.selfplay"))
        descents = snap.counters.get("zero.descent_steps", 0)
        log(f"  learn by CUDA events, over {selfplay_steps} self-play steps: "
            + ", ".join(f"{k} {v:.0f} ms" for k, v in split.items()))
        log(f"  learn: {wall:.1f} s; launches {launches}; descent steps {descents}, "
            f"self-play steps {selfplay_steps}")
        check(selfplay_steps == TRAIN_ITERATIONS * TRAIN_EPISODE_STEPS,
              f"{selfplay_steps} self-play commits for {TRAIN_ITERATIONS} x "
              f"{TRAIN_EPISODE_STEPS} steps")
        for name in ("spd_inverse", "edge_factor_gain"):
            check(launches[name] > 0, f"{name} was not launched on the training path")
        check(launches["edge_factor_gain"] == descents + selfplay_steps,
              "edge_factor_gain did not launch once per descent step and self-play step")
        check(launches["spd_inverse_factor"] == 0, "spd_inverse_factor launched in training")
        check(launches["spd_inverse"] == selfplay_steps, "spd_inverse: not one per commit")

        with open(os.path.join(tmp, "logs", "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        (out_dir / "train_metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        check(len(rows) == TRAIN_ITERATIONS, f"{len(rows)} metric rows")
        for r in rows:
            for k in ("policy_loss", "value_loss", "entropy", "total_loss", "grad_norm"):
                check(np.isfinite(r[k]), f"iteration {r['iteration']}: {k} not finite")
        traj = learner.replay._iters[TRAIN_ITERATIONS - 1]
        check(int(traj.sample_ok.sum()) > 0, "self-play produced no samples")
        check(bool(np.all(np.isfinite(traj.value)) and np.all(traj.value >= 0)),
              "value targets not finite or negative")
        # the root visit total of the last iteration's searches, where the
        # mission was running (sample_ok: running with a valid action)
        ns = torch.stack(visits.Ns[-TRAIN_EPISODE_STEPS:], dim=1).cpu().numpy()  # (E, T)
        running = ns[traj.sample_ok]
        log(f"  root visit totals of running missions: min {running.min():g}, max "
            f"{running.max():g} (want {sims - 1}); {int((~traj.sample_ok).sum())} roots not "
            f"running")
        check(bool(np.all(running == sims - 1)), "a self-play root's visit total is not sims - 1")
        after = learner.state.variables()
        moved = {s: share_changed(before, after, s) for s in (".weight", ".bias", "running_mean",
                                                              "running_var")}
        log("  share of tensors moved by training: "
            + ", ".join(f"{k} {v:.0%}" for k, v in moved.items()))
        check(moved[".weight"] > 0.5, "parameters did not change")
        check(moved["running_var"] > 0.5, "BatchNorm statistics did not change")
        # the deployment checkpoint reads back bitwise through the port's reader
        stored = read_checkpoint(learner.deployment_path())
        want = checkpoint_variables(learner.state)

        def leaves(tree, path=()):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    yield from leaves(tree[k], path + (k,))
                else:
                    yield path + (k,), tree[k]

        got, ref = list(leaves(stored)), list(leaves(want))
        check([p for p, _ in got] == [p for p, _ in ref] and all(
            g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
            for (_, g), (_, w) in zip(got, ref)), "deployment checkpoint does not read back")
        log(f"  deployment checkpoint: {len(got)} arrays read back bitwise")

        t0 = time.perf_counter()
        timing = train_step_timing(learner, hp, cfg)
        timing["loss_check_s"] = time.perf_counter() - t0

        # the arena gate: the learner's network against the one before training
        learner.arena.max_game_steps = ARENA_STEPS
        prev = load_checkpoint(os.path.join(tmp, "ckpt", "shared_net.temp"), learner.state)
        meter.wrap(learner.arena, "play_games", "arena")
        kernels.reset_launch_counts()
        before = tracing.counts("zero.").get("zero.descent_steps", 0)
        t0 = time.perf_counter()
        accepted = learner.arena_gate(prev, ARENA_GAMES)
        torch.cuda.synchronize()
        arena_wall = time.perf_counter() - t0
        arena_launches = kernels.launch_counts()
        arena_descents = tracing.counts("zero.")["zero.descent_steps"] - before
        arena_steps = 2 * ARENA_STEPS
        log(f"  arena gate: {ARENA_GAMES} games x {ARENA_STEPS} steps per network, "
            f"accepted={accepted}, {arena_wall:.1f} s; launches {arena_launches}; descent steps "
            f"{arena_descents}")
        check(arena_launches["edge_factor_gain"] == arena_descents + arena_steps,
              "edge_factor_gain did not launch once per arena descent step and game step")
        check(arena_launches["spd_inverse_factor"] == 0, "spd_inverse_factor launched in the arena")

    # self-play is SelfPlay.run alone, in the second iteration (no first-call
    # set-up); the learner's selfplay_s also holds the trajectory's copy to
    # the host, add_iteration and the npz write: the learner loop's I/O
    sp_s = meter.seconds["selfplay"][-1]
    sp_event_ms = span_ms(snap, "zero.selfplay")[-1]
    out = {
        "envs": TRAIN_ENVS, "episode_steps": TRAIN_EPISODE_STEPS, "iterations": TRAIN_ITERATIONS,
        "simulations": sims, "batch": hp.batch_size, "epochs": hp.num_epochs,
        "learn_wall_s": wall, "metrics": rows,
        "selfplay_ms_per_step": sp_s / TRAIN_EPISODE_STEPS * 1e3,
        "selfplay_ms_per_mission_step": sp_s / (TRAIN_EPISODE_STEPS * TRAIN_ENVS) * 1e3,
        "selfplay_event_ms_per_step": sp_event_ms / TRAIN_EPISODE_STEPS,
        "learner_selfplay_io_s": rows[-1]["selfplay_s"] - sp_s,
        "train_iteration_s": rows[-1]["train_s"],
        "arena_wall_s": arena_wall, "arena_ms_per_game_step": arena_wall / arena_steps * 1e3,
        "arena_accepted": accepted,
        "peak_mem_gb": meter.gb,
        "launches": {k: launches[k] + arena_launches[k] for k in launches},
        "launches_learn": launches, "launches_arena": arena_launches,
        "descent_steps": descents, "selfplay_steps": selfplay_steps, "moved": moved,
        "learn_split_ms": split,
        "arena_descent_steps": arena_descents, "arena_steps": arena_steps,
        **timing,
    }
    log(f"  self-play (SelfPlay.run, iteration 1): {out['selfplay_ms_per_step']:.1f} ms per step "
        f"of {TRAIN_ENVS} envs by the host clock ({out['selfplay_event_ms_per_step']:.1f} by CUDA "
        f"events), {out['selfplay_ms_per_mission_step']:.2f} ms per mission-step; the learner's "
        f"copy to the host, add_iteration and npz write {out['learner_selfplay_io_s']:.2f} s; train "
        f"iteration {out['train_iteration_s']:.2f} s; arena {out['arena_ms_per_game_step']:.1f} "
        f"ms per game step; peaks " + ", ".join(f"{k} {v:.2f} GB" for k, v in meter.gb.items()))
    return out


def training_agreement_phase(cfg) -> dict:
    log(f"== kernels vs plain versions on the training slice: committed checkpoint, self-play "
        f"E={TRAIN_AGREE_ENVS} x {TRAIN_AGREE_STEPS} steps and one arena batch of "
        f"{ARENA_GAMES} games x {ARENA_STEPS} steps, {TRAIN_AGREE_SIMS} simulations, "
        f"deterministic algorithms")
    mc = zero_mission(cfg, **CHECKPOINT_HP, max_episode_steps=TRAIN_AGREE_STEPS,
                      num_mcts_simulations=TRAIN_AGREE_SIMS)
    hp = mc.hyper_params
    world = IPPWorld(cfg)
    net = load_checkpoint(str(CHECKPOINT), init_network(cfg, hp, torch.Generator(device="cuda")))
    predict, variables = predict_fn(net), net.state_dict()
    selfplay = SelfPlay(world, hp, mc.episode_horizon,
                        ZeroMCTS(world, hp, mc.episode_horizon, predict))
    arena = Arena(world, hp, mc.episode_horizon, max_game_steps=ARENA_STEPS)

    def run():
        traj, values = selfplay.run(TRAIN_AGREE_ENVS, net_variables=variables,
                                    generator=torch.Generator(device="cuda").manual_seed(7))
        total = arena._play_batch(predict, variables, ARENA_GAMES,
                                  torch.Generator(device="cuda").manual_seed(8))
        return traj, values, total

    torch.backends.cudnn.benchmark = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        kernels.reset_launch_counts()
        with_kernels = run()
        launches = kernels.launch_counts()
        with plain_versions():
            plain = run()
        check(kernels.launch_counts() == launches, "a kernel launched under plain_versions()")
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("spd_inverse", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched in the training agreement run")
    (k_traj, k_values, k_total), (p_traj, p_values, p_total) = with_kernels, plain
    same = [name for name, a, b in zip(k_traj._fields, k_traj, p_traj) if torch.equal(a, b)]
    check(len(same) == len(k_traj._fields),
          f"trajectory fields differ: {sorted(set(k_traj._fields) - set(same))}")
    check(torch.equal(k_values, p_values), "episode values differ")
    check(torch.equal(k_total, p_total), "arena totals differ")
    samples = int(k_traj.sample_ok.sum())
    log(f"  trajectories ({samples} samples), episode values and arena totals identical; "
        f"launches with kernels {launches}; mean episode value {k_values.mean().item():.3f}, "
        f"arena total {k_total.sum().item():.3f}")
    return {"envs": TRAIN_AGREE_ENVS, "steps": TRAIN_AGREE_STEPS, "simulations": TRAIN_AGREE_SIMS,
            "arena_games": ARENA_GAMES, "arena_steps": ARENA_STEPS, "identical": True,
            "samples": samples, "launches": launches}


# ------------------------------------------------------------ static baselines

def static_phase(cfg) -> dict:
    log(f"== static baselines: example.yaml, float32, B={STATIC_B}, whole missions")
    world = IPPWorld(cfg)
    env, con = cfg.environment, cfg.constraints
    planners = {
        "lawnmower": LawnmowerPlanner(world, MissionConfig(type="lawnmower", step_size=5.0)),
        "spiral": SpiralPlanner(world, MissionConfig(type="spiral", num_waypoints=100)),
        "random_discrete": RandomDiscretePlanner(world, MissionConfig(type="random_discrete")),
        "random_continuous": RandomContinuousPlanner(
            world, MissionConfig(type="random_continuous")),
    }
    gen = torch.Generator(device="cuda").manual_seed(11)
    out, launches = {}, {}
    for name, planner in planners.items():
        planner.run(STATIC_B, max_steps=1, generator=gen)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = planner.run(STATIC_B, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps = res.budgets.shape[1] - 1
        check(counts["spd_inverse"] == steps,
              f"{name}: spd_inverse launched {counts['spd_inverse']} times in {steps} steps")
        check(sum(counts.values()) == steps, f"{name}: other kernels launched: {counts}")
        check(float(res.budgets.min()) >= 0.0, f"{name}: a budget went negative")
        wps = res.waypoints[~np.isnan(res.waypoints[..., 0])]
        lo = np.array([0.0, 0.0, con.min_altitude])
        hi = np.array([env.extent_x, env.extent_y, con.max_altitude])
        check(len(wps) > 0 and bool(np.all((wps >= lo) & (wps <= hi))),
              f"{name}: waypoints outside the box")
        unc = res.metrics["uncertainty"].mean(axis=0)
        check(unc[-1] < unc[0], f"{name}: the uncertainty did not fall")
        for k in launches.keys() | counts.keys():
            launches[k] = launches.get(k, 0) + counts[k]
        out[name] = {"steps": steps, "ms_per_step": wall / steps * 1e3,
                     "mean_flown_steps": float(res.num_steps.mean()),
                     "uncertainty": [float(unc[0]), float(unc[-1])], "launches": counts}
        log(f"  {name}: {steps} steps, {out[name]['ms_per_step']:.2f} ms per step, "
            f"{out[name]['mean_flown_steps']:.1f} steps flown on average, mean uncertainty "
            f"{unc[0]:.2f} -> {unc[-1]:.2f}; launches {counts}")
    out["launches"] = launches
    return out


# ------------------------------------------------------------ CMA-ES

def cmaes_mission(tcfg):
    mc = tcfg.missions[0]
    check(mc.type == "cmaes", "temperature_cmaes.yaml's first mission is not cmaes")
    return mc


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in µs, in ms."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e3


#: CUDA runtime calls with which the host waits for the device
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def fitness_profile(planner, state, gen, repeats: int = 5) -> dict:
    """Where one fitness call's time goes: the generation's B·λ members
    (a first generation's draws around the greedy plan) and the greedy
    plan's B.  Per case, ``repeats`` calls on the host clock, each timed
    to its return (the host's enqueue) and to a synchronise after it (its
    wall), then one call under ``torch.profiler``: the device's kernels
    and copies, the host's kernel launches and synchronisations, and the
    union of the device's intervals, whose share of the unprofiled median
    wall is the device's busy share (1 − idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    world, cfg = planner.world, planner.cfg
    H, lam, B = planner.horizon, planner.popsize, state.batch_size
    con, env = cfg.constraints, cfg.environment
    lower = torch.tensor([0.0, 0.0, con.min_altitude], device="cuda").repeat(H)
    upper = torch.tensor([env.extent_x, env.extent_y, con.max_altitude], device="cuda").repeat(H)
    actions, _ = cmaes.greedy_search_horizon(world, state, H)
    x0 = world.actions_xyz[actions].reshape(B, 3 * H)
    scales = torch.as_tensor(planner.sigma_scales, device="cuda")
    z = torch.randn((B, lam, 3 * H), generator=gen, device="cuda")
    members = torch.clamp(x0[:, None, :] + z * scales, lower, upper)  # C = diag(scales²), σ = 1

    def call(x):
        return planner.trajectory_loss(x, state.cov, state.mean, state.pos, state.budget)

    out = {}
    for case, x in (("generation", members), ("greedy_plan", x0[:, None, :])):
        enqueue, wall = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
        row = {"members": x.shape[0] * x.shape[1], "enqueue_ms": enqueue, "wall_ms": wall}
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(x)
                torch.cuda.synchronize()
            events = prof.events()
            device = [e for e in events if e.device_type == DeviceType.CUDA]
            host = [e.name for e in events if e.device_type == DeviceType.CPU]
            syncs = sum(1 for n in host if n in SYNC_CALLS) - ("cudaDeviceSynchronize" in host)
            busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in device])
            row.update({
                "device_kernels": sum(1 for e in device if "memcpy" not in e.name.lower()
                                      and "memset" not in e.name.lower()),
                "device_copies": sum(1 for e in device if "memcpy" in e.name.lower()
                                     or "memset" in e.name.lower()),
                "host_launches": sum(1 for n in host if "LaunchKernel" in n),
                "host_syncs": syncs,  # less our own synchronise after the call
                "device_busy_ms": busy if device else None,
                "device_busy_share": busy / float(np.median(wall)) if device else None,
            })
        except Exception as e:  # the profiler is a measurement, not a check
            row["profile_error"] = f"{type(e).__name__}: {e}"
        out[case] = row
        share = row.get("device_busy_share")
        log(f"  fitness at {row['members']} members: wall {np.median(wall):.2f} ms, enqueue "
            f"{np.median(enqueue):.2f} ms (medians of {repeats}); profiled: "
            + (f"{row['device_kernels']} kernels + {row['device_copies']} copies, "
               f"{row['host_launches']} host launches, {row['host_syncs']} host syncs, "
               f"device busy {row['device_busy_ms']:.2f} ms = {share:.3f} of the wall"
               if share is not None else "no device events (" + row.get("profile_error", "")
               + ")"))
    return out


def cmaes_phase(tcfg) -> dict:
    mc = cmaes_mission(tcfg)
    H, G, lam = mc.episode_horizon, mc.cma_maxiter, mc.cma_popsize
    log(f"== CMA-ES: temperature_cmaes.yaml mission 0, lambda {lam}, {G} generations, "
        f"horizon {H}, sigma0 {mc.cma_sigma}, float32, B={CMAES_B}, {CMAES_STEPS} replan steps")
    world = IPPWorld(tcfg)
    planner = CMAESPlanner(world, mc)
    gen = torch.Generator(device="cuda").manual_seed(12)
    warm = CMAESPlanner(world, dataclasses.replace(mc, cma_maxiter=1))
    warm.run(CMAES_B, max_steps=1, generator=gen)  # warm-up: cuBLAS, cuSOLVER, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tracing.reset(counters=TWO_STAGE)
    t0 = time.perf_counter()
    res = planner.run(CMAES_B, max_steps=CMAES_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, two_stage = kernels.launch_counts(), two_stage_calls()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"edge_factor_gain": CMAES_STEPS * (G * H + H),
            "spd_trace_product": CMAES_STEPS * H * 2,
            "spd_inverse": CMAES_STEPS * (H + 1), "spd_inverse_factor": 0,
            "sweep_tap_blocks": CMAES_STEPS * H}
    log(f"  launches in the run: {launches} (want {want}); two-stage sweeps {two_stage}")
    check(launches == want, "CMA-ES launch counts differ from the stated ones")
    check(two_stage == 0, "the CMA-ES init's sweeps took the two-stage route")
    unc = res.metrics["uncertainty"].mean(axis=0)
    check(res.waypoints.shape == (CMAES_B, CMAES_STEPS, 3), f"waypoints {res.waypoints.shape}")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"metric {k} not finite")
    check(bool(np.all(np.diff(unc) < 0)), "uncertainty does not fall step over step")
    check(float(res.budgets.min()) >= 0.0, "a budget went negative")
    env, con = tcfg.environment, tcfg.constraints
    wps = res.waypoints[~np.isnan(res.waypoints[..., 0])]
    check(len(wps) > 0 and bool(np.all((wps >= [0.0, 0.0, con.min_altitude])
                                       & (wps <= [env.extent_x, env.extent_y, con.max_altitude]))),
          "CMA-ES waypoints outside the box")
    log(f"  mean uncertainty per step: {np.array2string(unc, precision=3)}")

    state = res.final_state
    split, fitness = cmaes_replan_split(planner, world, state, gen)
    fit_profile = fitness_profile(planner, state, gen)
    out = {
        "batch": CMAES_B, "steps": CMAES_STEPS, "popsize": lam, "generations": G, "horizon": H,
        "run_wall_s": wall, "ms_per_step": wall / CMAES_STEPS * 1e3,
        "ms_per_mission_replan": wall / (CMAES_B * CMAES_STEPS) * 1e3,
        "peak_mem_gb": peak, "mean_uncertainty": unc.tolist(), "launches": launches,
        "replan_split_ms": split, "fitness_call_ms": fitness, "fitness_profile": fit_profile,
    }
    log(f"  run: {out['ms_per_step']:.1f} ms per replan step, "
        f"{out['ms_per_mission_replan']:.4f} ms per mission-replan; peak {peak:.2f} GB")
    return out


def cmaes_replan_split(planner, world, state, gen) -> tuple:
    """One more replan and its commit, split by the program's spans' CUDA
    events: (ms per part, ms of each fitness call)."""
    with traced() as snap:
        wps_next, valid = planner.replan_batch(state, generator=gen)
        world.step_position(state.replace(active=state.active & valid), wps_next[:, 0],
                            generator=gen)
    fitness = span_ms(snap[0], "cmaes.fitness")  # G inside CMA-ES, then the greedy plan's
    split = {part: sum(span_ms(snap[0], name)) for part, name in (
        ("greedy_init", "cmaes.init"), ("cma", "cmaes.minimize"), ("fitness", "cmaes.fitness"),
        ("eigh", "cmaes.eigh"), ("replan", "cmaes.replan"), ("commit", "plan.commit"))}
    split["cma_update"] = split["cma"] - sum(fitness[:-1])
    split["other"] = split["replan"] - split["greedy_init"] - split["cma"] - fitness[-1]
    log("  one replan by CUDA events: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; {len(fitness)} fitness calls, {np.mean(fitness):.2f} ms each")
    return split, fitness


def cmaes_agreement_phase(tcfg) -> dict:
    log(f"== kernels vs plain versions on CMA-ES: B={CMAES_AGREE_B}, {CMAES_AGREE_STEPS} replans")
    world = IPPWorld(tcfg)
    planner = CMAESPlanner(world, cmaes_mission(tcfg))
    gen = torch.Generator(device="cuda").manual_seed(13)
    state0 = world.init_state(CMAES_AGREE_B, gen)
    noise = torch.randn((CMAES_AGREE_STEPS, CMAES_AGREE_B, world.m_max_cont), generator=gen,
                        device="cuda")

    def run():
        return planner.run(CMAES_AGREE_B, CMAES_AGREE_STEPS, init_state=state0, noise=noise,
                           generator=torch.Generator(device="cuda").manual_seed(14))

    kernels.reset_launch_counts()
    with_kernels = run()
    launches = kernels.launch_counts()
    with plain_versions():
        plain = run()
    check(kernels.launch_counts() == launches, "a kernel launched under plain_versions()")
    for name in ("spd_inverse", "spd_trace_product", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched in the CMA-ES agreement run")
    check(np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True),
          "CMA-ES waypoints differ between kernels and plain versions")
    check(np.array_equal(with_kernels.budgets, plain.budgets), "budgets differ")
    for k, v in plain.metrics.items():
        check(np.array_equal(with_kernels.metrics[k], v, equal_nan=True), f"metric {k} differs")
    log(f"  waypoints, budgets and metric curves identical; launches with kernels {launches}")
    return {"batch": CMAES_AGREE_B, "steps": CMAES_AGREE_STEPS, "identical": True,
            "launches": launches}


# ------------------------------------------------------------ classic MCTS

def classic_mission(**changes) -> MissionConfig:
    return MissionConfig(**{**CLASSIC_KNOBS, **changes})


class SearchRecorder:
    """Records, for every search a classic planner runs (a wrapper around
    its ``search`` and ``plan``, in this script only): the root visit
    totals, the per-row root statistics, the actions, and with ``trees``
    a copy of each whole tree."""

    def __init__(self, planner, trees: bool = False):
        self.root_visits, self.stats, self.actions, self.trees = [], [], [], []
        search, plan = planner.search, planner.plan

        def recorded_search(*args, **kw):
            tree, stats = search(*args, **kw)
            self.root_visits.append(tree.visits[:, 0].clone())
            self.stats.append(stats)
            if trees:
                self.trees.append({f: getattr(tree, f).clone() for f in CLASSIC_TREE_FIELDS})
            return tree, stats

        def recorded_plan(*args, **kw):
            action = plan(*args, **kw)
            self.actions.append(action.clone())
            return action

        planner.search, planner.plan = recorded_search, recorded_plan


@contextlib.contextmanager
def classic_split(planner):
    """Splits the replans run inside the block by CUDA events, per replan:
    in the descent and in the rollouts the sweeps, the edge updates with
    their rank-M updates, and the rest (UCT, widening and tree writes; the
    rollout policy's choices); the backup with the root statistics; the
    commit.  The dict it yields is filled when the block ends."""
    split = {}
    with traced() as snap:
        yield split
    snap = snap[0]

    def ms(name, inside=None):
        return sum(span_ms(snap, name, inside))

    n = span_count(snap, "classic.search")
    sweeps = sum(len(span_ms(snap, "classic.sweep", inside))
                 for inside in ("classic.descent", "classic.rollout"))
    in_descent = ms("classic.sweep", "classic.descent") + ms("classic.edge", "classic.descent")
    in_rollout = ms("classic.sweep", "classic.rollout") + ms("classic.edge", "classic.rollout")
    split.update({
        "replans": n,
        "sweeps": (ms("classic.sweep", "classic.descent")
                   + ms("classic.sweep", "classic.rollout")) / n,
        "edges_rank_m": (ms("classic.edge", "classic.descent")
                         + ms("classic.edge", "classic.rollout")) / n,
        "descent_uct_tree": (ms("classic.descent") - in_descent) / n,
        "rollout_policy": (ms("classic.rollout") - in_rollout) / n,
        "backup_root_stats": ms("classic.backup") / n,
        "other": (ms("classic.search") - ms("classic.descent") - ms("classic.rollout")
                  - ms("classic.backup")) / n,
        "replan": ms("classic.search") / n,
        "commit": ms("plan.commit") / span_count(snap, "plan.commit"),
        "sweep_ms_each": (ms("classic.sweep", "classic.descent")
                          + ms("classic.sweep", "classic.rollout")) / sweeps,
    })


def classic_phase(cfg) -> dict:
    mc = classic_mission()
    world = IPPWorld(cfg)
    planner = ClassicMCTSPlanner(world, mc)
    S, H = planner.num_simulations, planner.horizon
    steps_per_sim = (H + 1) + H  # descent steps and rollout steps, every one in lockstep
    log(f"== classic MCTS: example.yaml, float32, {S} simulations, horizon {H}, W = 1, "
        f"gamma {mc.gamma}, c {mc.uct_c}, k {mc.k}, alpha {mc.alpha}, eps {mc.epsilon_expand}/"
        f"{mc.epsilon_rollout}, radius {mc.horizontal_spacing}, GCB {mc.use_gcb_rollout}; "
        f"B={CLASSIC_B}, {CLASSIC_STEPS} replan steps")
    gen = torch.Generator(device="cuda").manual_seed(20)
    # warm-up at the run's shapes with 2 simulations: cuBLAS handles, allocator
    ClassicMCTSPlanner(world, classic_mission(num_simulations=2)).run(CLASSIC_B, max_steps=1,
                                                                      generator=gen)
    rec = SearchRecorder(planner)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with classic_split(planner) as split:
        kernels.reset_launch_counts()
        tracing.reset(counters=TWO_STAGE)
        t0 = time.perf_counter()
        res = planner.run(CLASSIC_B, max_steps=CLASSIC_STEPS, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, two_stage = kernels.launch_counts(), two_stage_calls()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_replan = S * steps_per_sim
    want = {"spd_inverse": CLASSIC_STEPS, "spd_inverse_factor": 0,
            "spd_trace_product": 2 * CLASSIC_STEPS * per_replan,
            "edge_factor_gain": CLASSIC_STEPS * per_replan,
            "sweep_tap_blocks": CLASSIC_STEPS * per_replan}
    log(f"  launches in the run: {launches} (want {want}: per replan S (Hc + H) = {per_replan} "
        f"edge updates, two trace-product launches and one tap launch per sweep, one commit); "
        f"two-stage sweeps {two_stage}")
    check(launches == want, "classic launch counts differ from the stated ones")
    check(two_stage == 0, "the classic sweeps took the two-stage route")
    check(len(rec.root_visits) == CLASSIC_STEPS, f"{len(rec.root_visits)} searches")
    root = torch.stack(rec.root_visits)
    log(f"  root visits: min {root.min().item():g}, max {root.max().item():g} (want {S} for every "
        f"mission at every replan)")
    check(bool((root == S).all()), "a root's visit total is not the simulation count")
    unc = res.metrics["uncertainty"].mean(axis=0)
    check(res.waypoints.shape == (CLASSIC_B, CLASSIC_STEPS, 3), f"waypoints {res.waypoints.shape}")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"metric {k} not finite")
    check(bool(np.all(np.diff(unc) < 0)), "uncertainty does not fall step over step")
    log(f"  mean uncertainty per step: {np.array2string(unc, precision=3)}")

    log("  per replan and commit of the run, by CUDA events (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items() if k not in ("replans", "sweep_ms_each"))
        + f"; {split['sweep_ms_each']:.3f} ms per sweep")
    out = {
        "batch": CLASSIC_B, "steps": CLASSIC_STEPS, "simulations": S, "horizon": H,
        "workers": 1, "run_wall_s": wall, "ms_per_step": wall / CLASSIC_STEPS * 1e3,
        "ms_per_mission_replan": wall / (CLASSIC_B * CLASSIC_STEPS) * 1e3,
        "peak_mem_gb": peak, "mean_uncertainty": unc.tolist(), "launches": launches,
        "root_visits": [root.min().item(), root.max().item()], "replan_split_ms": split,
    }
    log(f"  run: {out['ms_per_step']:.1f} ms per replan step, "
        f"{out['ms_per_mission_replan']:.3f} ms per mission-replan; peak {peak:.2f} GB")

    # root-parallel: W workers of S / W simulations each, R = B·W rows
    W = CLASSIC_WORKERS
    p4 = ClassicMCTSPlanner(world, classic_mission(num_mcts_workers=W))
    S4, B4 = p4.num_simulations, CLASSIC_B // W
    rec4 = SearchRecorder(p4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res4 = p4.run(B4, max_steps=1, generator=gen)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    launches4 = kernels.launch_counts()
    want4 = {"spd_inverse": 1, "spd_inverse_factor": 0,
             "spd_trace_product": 2 * S4 * steps_per_sim, "edge_factor_gain": S4 * steps_per_sim,
             "sweep_tap_blocks": S4 * steps_per_sim}
    log(f"== classic MCTS root-parallel: W = {W}, {S4} simulations per worker, B={B4} "
        f"(R = {B4 * W} rows), 1 replan step; launches {launches4} (want {want4})")
    check(launches4 == want4, "root-parallel launch counts differ from the stated ones")
    root4 = rec4.root_visits[0].view(B4, W)
    check(bool((root4 == S4).all()), "a worker's root visit total is not its simulation count")
    check(bool((root4.sum(dim=1) == W * S4).all()), "a mission's root visits do not sum to S")
    stats = rec4.stats[0]
    vis = stats.visits.view(B4, W, -1).sum(dim=1)
    val = stats.values.view(B4, W, -1).sum(dim=1)
    merged = torch.where(vis > 0, val / vis.clamp(min=1e-30), float("-inf"))
    chosen = merged.gather(1, rec4.actions[0][:, None])[:, 0]
    check(bool((chosen == merged.amax(dim=1)).all()),
          "the action is not the best of the merged per-action statistics")
    unc4 = res4.metrics["uncertainty"].mean(axis=0)
    check(bool(unc4[-1] < unc4[0]), "uncertainty does not fall (root-parallel)")
    out["root_parallel"] = {
        "workers": W, "simulations_per_worker": S4, "batch": B4, "rows": B4 * W,
        "ms_per_step": wall4 * 1e3, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches4, "mean_uncertainty": unc4.tolist(),
        "mission_root_visits": [root4.sum(dim=1).min().item(), root4.sum(dim=1).max().item()],
    }
    log(f"  root visits per worker {S4}, per mission {W * S4} (checked); the actions maximise "
        f"the merged per-action means; {wall4 * 1e3:.1f} ms per replan step, peak "
        f"{out['root_parallel']['peak_mem_gb']:.2f} GB; mean uncertainty "
        f"{np.array2string(unc4, precision=3)}")
    return out


def classic_agreement_phase(cfg) -> dict:
    log(f"== kernels vs plain versions on classic MCTS: B={CLASSIC_AGREE_B}, "
        f"{CLASSIC_AGREE_SIMS} simulations, one replan and its commit, W = 1 and W = 2 with GCB")
    world = IPPWorld(cfg)
    out = {}
    for name, fields in (("w1", {}), ("w2_gcb", dict(num_mcts_workers=2, use_gcb_rollout=True))):
        planner = ClassicMCTSPlanner(world, classic_mission(num_simulations=CLASSIC_AGREE_SIMS,
                                                            **fields))
        rec = SearchRecorder(planner, trees=True)
        gen = torch.Generator(device="cuda").manual_seed(21)
        state0 = world.init_state(CLASSIC_AGREE_B, gen)
        noise = torch.randn((1, CLASSIC_AGREE_B, world.H.shape[1]), generator=gen, device="cuda")

        def run():
            return planner.run(CLASSIC_AGREE_B, 1, init_state=state0, noise=noise,
                               generator=torch.Generator(device="cuda").manual_seed(22))

        kernels.reset_launch_counts()
        with_kernels = run()
        launches = kernels.launch_counts()
        with plain_versions():
            plain = run()
        check(kernels.launch_counts() == launches, "a kernel launched under plain_versions()")
        for k in ("spd_inverse", "spd_trace_product", "edge_factor_gain"):
            check(launches[k] > 0, f"{k} was not launched in the classic agreement run")
        (tk, tp), (ak, ap) = rec.trees, rec.actions
        for f in CLASSIC_TREE_FIELDS:
            check(torch.equal(tk[f], tp[f]), f"{name}: tree field {f} differs from the plain run")
        check(torch.equal(ak, ap), f"{name}: actions differ between kernels and plain versions")
        check(np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True),
              f"{name}: waypoints differ")
        for k, v in plain.metrics.items():
            check(np.array_equal(with_kernels.metrics[k], v, equal_nan=True),
                  f"{name}: metric {k} differs")
        allocated = tk["next_free"] - 1
        out[name] = {"identical": True, "launches": launches, "rows": tk["visits"].shape[0],
                     "nodes_allocated": [int(allocated.min()), int(allocated.max())]}
        log(f"  {name}: trees ({', '.join(CLASSIC_TREE_FIELDS)}), actions, waypoints and metrics "
            f"identical over {tk['visits'].shape[0]} rows; launches with kernels {launches}")
    return out


def entry_points_phase() -> dict:
    """The port's two entry points as a user starts them, in two
    subprocesses side by side with implicit training refused: the
    experiment runner over all eight mission types on example.yaml (the
    committed checkpoint for mcts_zero), and the training script at a tiny
    size.  Each one's seconds run from the common start to its exit."""
    import importlib.util

    import yaml

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"== entry points: python -m ipp_rl_tpu_torch.main (eight missions, B=32, 8 steps) and "
        f"python -m ipp_rl_tpu_torch.tools.train_zero (tiny); matplotlib "
        f"{'present' if has_mpl else 'ABSENT: --no-plots'}")
    out_dir = ROOT / "chiprun_out" / "entry_points"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    raw = yaml.safe_load((CONFIG_DIR / "example.yaml").read_text())
    missions = raw["experiment"]["missions"]
    check(missions[0]["type"] == "mcts_zero", "example.yaml's first mission is not mcts_zero")
    missions[0]["hyper_params"].update(CHECKPOINT_HP)
    missions += [
        {"type": "spiral", "color": "black", "num_waypoints": 100},
        {"type": "random_continuous", "color": "gray"},
        {**CLASSIC_KNOBS, "color": "cyan"},
        {"type": "cmaes", "color": "purple", "episode_horizon": 5, "cma_popsize": 12,
         "cma_maxiter": 20},
    ]
    config = out_dir / "eight_missions.yaml"
    config.write_text(yaml.safe_dump(raw))
    env = {**os.environ, "IPP_ALLOW_IMPLICIT_TRAINING": "0"}
    runs = {  # the two run side by side: each paces itself on the host
        "main": ["ipp_rl_tpu_torch.main", "--config", str(config), "--batch", "32",
                 "--max-steps", "8", "--results", str(out_dir / "results"),
                 "--checkpoints", str(CHECKPOINT.parent), "--logs", str(out_dir / "logs")]
        + ([] if has_mpl else ["--no-plots"]),
        "train_zero": ["ipp_rl_tpu_torch.tools.train_zero", "--iterations", "1", "--envs", "16",
                       "--sims", "16", "--max-episode-steps", "4", "--batch-size", "32",
                       "--epochs", "1", "--eval-batch", "8", "--eval-steps", "4", "--out",
                       str(out_dir / "train_zero")],
    }
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    try:
        for name, args in runs.items():
            log_file = open(out_dir / f"{name}.log", "w")
            procs[name] = (subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                            stdout=log_file, stderr=subprocess.STDOUT), log_file)
        while len(seconds) < len(procs) and time.perf_counter() - t0 < ENTRY_POINTS_TIMEOUT_S:
            for name, (proc, _) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for proc, log_file in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    for name, (proc, _) in procs.items():
        if proc.returncode != 0:
            log((out_dir / f"{name}.log").read_text()[-4000:])
        check(name in seconds, f"{name} did not end within {ENTRY_POINTS_TIMEOUT_S} s")
        check(proc.returncode == 0, f"{name} exited with {proc.returncode}")
    main_s, train_s = seconds["main"], seconds["train_zero"]
    (result,) = (out_dir / "results").iterdir()
    kpis = json.loads((result / "kpis.json").read_text())
    check(len(kpis) == 8, f"kpis.json has {len(kpis)} rows, not 8")
    with open(result / "experiment.pkl", "rb") as f:
        bundle = pickle.load(f)
    rows = {}
    for name, res in bundle["results"].items():
        unc = res["metrics"]["uncertainty"]
        rows[name] = {"prior": float(unc[:, 0].mean()), "final": float(unc[:, -1].mean()),
                      "mean_steps": float(res["num_steps"].mean()),
                      "wall_s": bundle["run_times"][name]}
        check(rows[name]["final"] < rows[name]["prior"],
              f"{name}: the final uncertainty is not below the prior")
    if has_mpl:
        for plot in ("uncertainty.png", "paths_3d.png", "run_stats.png"):
            check((result / "plots" / plot).exists(), f"plot {plot} missing")
    finished = [json.loads(line) for line in (out_dir / "logs" / "notifications.jsonl")
                .read_text().splitlines() if json.loads(line)["kind"] == "finished"]
    check(len(finished) == 1, "the experiment did not report its end")
    launches = finished[0]["info"]["kernel_launches"]
    for k in ("spd_inverse", "spd_trace_product", "edge_factor_gain"):
        check(launches[k] > 0, f"{k} was not launched by the experiment")
    for name, r in rows.items():
        log(f"  {name}: mean uncertainty {r['prior']:.2f} -> {r['final']:.2f}, "
            f"{r['mean_steps']:.1f} steps, {r['wall_s']:.1f} s")
    log(f"  main: exit 0 in {main_s:.1f} s, 8 KPI rows, experiment.pkl loads, plots "
        f"{'written' if has_mpl else 'skipped (--no-plots)'}; kernel launches {launches}")

    ev = json.loads((out_dir / "train_zero" / "eval.json").read_text())
    check(list(ev) == ["mcts_zero", "greedy", "random"], f"eval.json rows {list(ev)}")
    check(all(np.isfinite(r["final_uncertainty"]) for r in ev.values()),
          "eval.json holds a non-finite uncertainty")
    log(f"  train_zero: exit 0 in {train_s:.1f} s; eval.json final uncertainty "
        + ", ".join(f"{k} {v['final_uncertainty']:.2f}" for k, v in ev.items()))
    return {"matplotlib": has_mpl, "main_s": main_s, "train_zero_s": train_s, "missions": rows,
            "launches": launches, "train_zero_eval": {k: v["final_uncertainty"]
                                                     for k, v in ev.items()}}


# ------------------------------------------------------------ deployment

def drive(obj, fn):
    """fn() with the host seconds of ``obj``'s commits, planner runs and the
    UAV's flights (a PartMeter: synchronised around each, nested calls
    inside their callers') and its zero descent steps counted; returns
    (fn's result, wall seconds, meter, descent steps)."""
    from ipp_rl_tpu_torch.ros.sim_robot import SimulatedUAV

    meter, fly = PartMeter(), SimulatedUAV.fly
    meter.wrap(obj.world, "step_index", "commit")
    meter.wrap(obj.world, "step_position", "measure_commit")
    meter.wrap(obj.planner, "run", "plan")
    meter.wrap(SimulatedUAV, "fly", "fly")
    before = tracing.counts("zero.").get("zero.descent_steps", 0)
    try:
        t = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t
    finally:
        SimulatedUAV.fly = fly
    return result, wall, meter, tracing.counts("zero.").get("zero.descent_steps", 0) - before


def check_trajectory_ends(name: str, points, trajectories, tol: float) -> float:
    """Every trajectory's last sample within ``tol`` of its waypoint; returns
    the largest gap."""
    gaps = [float(np.linalg.norm(np.asarray(traj)[-1] - np.asarray(wp)))
            for wp, traj in zip(points, trajectories)]
    check(max(gaps) <= tol, f"{name}: a trajectory ends {max(gaps):.3f} m from its waypoint "
          f"(tolerance {tol:g} m)")
    return max(gaps)


def deploy_phase(cfg) -> dict:
    """The deployment entry points at one mission (phase 13)."""
    from ipp_rl_tpu_torch.ros import IPPMissionNode
    from ipp_rl_tpu_torch.ros import sim_robot

    log(f"== deployment: IPPMissionNode (mcts_zero with the committed checkpoint, "
        f"{DEPLOY_ZERO_NODE_STEPS} steps; greedy, whole mission) and ClosedLoopMission (greedy, "
        f"whole budget, tracking noise 0 and {DEPLOY_TRACKING_STD}; mcts_zero, "
        f"{DEPLOY_ZERO_CYCLES} cycles, noise {DEPLOY_TRACKING_STD}), example.yaml, float32, B=1")
    zero_mc, greedy_mc = zero_mission(cfg, **CHECKPOINT_HP), MissionConfig(type="greedy")
    ckpt = str(CHECKPOINT.parent)
    t0 = time.perf_counter()
    nodes = {"zero": IPPMissionNode(cfg, zero_mc, checkpoints_dir=ckpt),
             "greedy": IPPMissionNode(cfg, greedy_mc)}
    loops = {"greedy": sim_robot.ClosedLoopMission(cfg, greedy_mc),
             "greedy_noisy": sim_robot.ClosedLoopMission(
                 cfg, greedy_mc, tracking_noise_std=DEPLOY_TRACKING_STD),
             "zero_noisy": sim_robot.ClosedLoopMission(
                 cfg, zero_mc, tracking_noise_std=DEPLOY_TRACKING_STD, checkpoints_dir=ckpt)}
    setup_s = time.perf_counter() - t0

    out = {"setup_s": setup_s, "nodes": {}, "loops": {}}
    commits = descents = 0
    kernels.reset_launch_counts()
    for name, node, steps in (("zero", nodes["zero"], DEPLOY_ZERO_NODE_STEPS),
                              ("greedy", nodes["greedy"], None)):
        msg, wall, meter, desc = drive(node, lambda: node.build_message(max_steps=steps))
        n = len(msg.points)
        check(n >= 2 and msg.sampled_trajectory is not None, f"node {name}: {n} points")
        check(steps is None or n == steps, f"node {name}: {n} points for {steps} steps")
        check_trajectory_ends(f"node {name}", msg.points[-1:], [msg.sampled_trajectory],
                              TRAJECTORY_END_TOL_M)
        check(json.loads(msg.to_json())["points"] == msg.points, f"node {name}: JSON")
        commits += len(meter.seconds["commit"])
        descents += desc
        # a node's run takes the planner's whole step bound; a mission that
        # ran out of budget still commits (nothing) in the steps after it
        out["nodes"][name] = {"points": n, "samples": len(msg.sampled_trajectory),
                              "wall_s": wall, "ms_per_waypoint": wall / n * 1e3,
                              "commits": len(meter.seconds["commit"]), "descent_steps": desc}
        log(f"  node {name}: {n} waypoints, {len(msg.sampled_trajectory)} trajectory samples, "
            f"{len(meter.seconds['commit'])} commits, {wall:.2f} s ({wall / n * 1e3:.1f} ms per "
            f"waypoint)")
    for name, loop in loops.items():
        cycles = DEPLOY_ZERO_CYCLES if name.startswith("zero") else 64
        flog, wall, meter, desc = drive(loop, lambda: loop.run(max_cycles=cycles))
        n = len(flog.waypoints)
        check(n == cycles if name.startswith("zero") else 1 <= n < cycles,
              f"loop {name}: {n} cycles, budget left {flog.budgets[-1]:.2f}")
        check(flog.uncertainty[-1] < flog.uncertainty[0], f"loop {name}: uncertainty rose")
        check(all(b1 < b0 for b0, b1 in zip(flog.budgets, flog.budgets[1:])),
              f"loop {name}: the budget did not fall every cycle")
        tol = TRAJECTORY_END_TOL_M if loop.tracking_noise_std == 0 else (
            cfg.uav.max_v * cfg.uav.sampling_time)
        end_gap = check_trajectory_ends(f"loop {name}", flog.waypoints, flog.trajectories, tol)
        gaps = [float(np.linalg.norm(np.subtract(p, w))) for p, w in
                zip(flog.poses, flog.waypoints)]
        check((max(gaps) > 0) == (loop.tracking_noise_std > 0),
              f"loop {name}: poses vs waypoints {max(gaps):.3f} m")
        sec = {k: sum(meter.seconds.get(k, ())) for k in
               ("plan", "fly", "commit", "measure_commit")}
        n_commits = len(meter.seconds["commit"]) + len(meter.seconds.get("measure_commit", ()))
        commits += n_commits
        descents += desc
        split = {"plan": (sec["plan"] - sec["commit"]) / n * 1e3, "fly": sec["fly"] / n * 1e3,
                 "measure_commit": (sec["commit"] + sec["measure_commit"]) / n * 1e3}
        out["loops"][name] = {
            "cycles": n, "wall_s": wall, "ms_per_cycle": wall / n * 1e3, "split_ms": split,
            "uncertainty": [flog.uncertainty[0], flog.uncertainty[-1]],
            "rmse": [flog.rmse[0], flog.rmse[-1]], "budget_left": flog.budgets[-1],
            "max_pose_error_m": max(gaps), "max_trajectory_end_gap_m": end_gap,
            "commits": n_commits, "descent_steps": desc}
        log(f"  loop {name}: {n} cycles, uncertainty {flog.uncertainty[0]:.2f} -> "
            f"{flog.uncertainty[-1]:.2f}, max pose error {max(gaps):.3f} m, trajectory ends "
            f"within {end_gap:.3f} m (tolerance {tol:g}), {wall / n * 1e3:.1f} ms per cycle: "
            f"plan {split['plan']:.1f}, fly (host C++) {split['fly']:.2f}, measure + commit "
            f"{split['measure_commit']:.2f}")
    launches = kernels.launch_counts()
    log(f"  launches in the deployment run: {launches}; commits {commits}, zero descent steps "
        f"{descents}")
    check(launches["spd_inverse"] == commits, "spd_inverse did not launch once per commit")
    check(descents > 0 and launches["edge_factor_gain"] == descents,
          "edge_factor_gain did not launch once per descent step")
    check(launches["spd_trace_product"] > 0, "spd_trace_product was not launched (greedy sweeps)")
    check(launches["spd_inverse_factor"] == 0, "spd_inverse_factor launched on the deploy path")
    out.update(launches=launches, commits=commits, descent_steps=descents)

    # the greedy loop with the kernels and with their plain versions
    loop = sim_robot.ClosedLoopMission(cfg, greedy_mc, seed=7,
                                       tracking_noise_std=DEPLOY_TRACKING_STD)
    kernels.reset_launch_counts()
    with_kernels = loop.run()
    agree_launches = kernels.launch_counts()
    with plain_versions():
        plain = loop.run()
    check(kernels.launch_counts() == agree_launches, "a kernel launched under plain_versions()")
    check(agree_launches["spd_inverse"] > 0 and agree_launches["spd_trace_product"] > 0,
          "the agreement loop launched no kernel")
    check(with_kernels.to_json() == plain.to_json(),
          "the flight logs differ between kernels and plain versions")
    log(f"  greedy loop (noise {DEPLOY_TRACKING_STD}, {len(plain.waypoints)} cycles): flight logs "
        f"identical with kernels and plain versions; launches with kernels {agree_launches}")
    out["agreement"] = {"cycles": len(plain.waypoints), "identical": True,
                        "launches": agree_launches}
    return out


# ------------------------------------------------------------ multi-device

def grid_draws(world, gen: torch.Generator):
    """A ground truth and GRID_STEPS steps of measurement noise (T, M)."""
    gt = world.init_state(1, gen).ground_truth[0]
    return gt, torch.randn((GRID_STEPS, world.H.shape[1]), generator=gen, device="cuda",
                           dtype=world.dtype)


def two_rank_worker(rank: int, workdir: pathlib.Path) -> int:
    """One of two ranks on the one card over gloo (``--two-rank-worker``):
    probe whether all_reduce, all_gather_into_tensor and all_to_all_single
    take CUDA tensors; if all do, run the 20 x 20 sharded mission at mp = 2
    from the parent's draws.  Rank 0 writes ``two_rank.json``."""
    import torch.distributed as dist

    from ipp_rl_tpu_torch.parallel import make_mesh
    from ipp_rl_tpu_torch.parallel.large_grid import sharded_greedy_mission

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        x = torch.full((4,), float(rank + 1), device="cuda", dtype=torch.float64)
        probes = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8, device="cuda", dtype=torch.float64), x),
            "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        }
        probe = {}
        for name, fn in probes.items():
            try:
                fn()
                torch.cuda.synchronize()
                probe[name] = "ok"
            except Exception as e:  # the probe's finding, reported by the parent
                probe[name] = f"{type(e).__name__}: {e}"[:300]
        result = {"probe": probe}
        if all(v == "ok" for v in probe.values()):
            draws = torch.load(workdir / "draws.pt", map_location="cuda")
            world = IPPWorld(large_grid_cfg(20), dtype=torch.float64)
            t = time.perf_counter()
            run = sharded_greedy_mission(make_mesh(mp=2), world, GRID_STEPS, noise=draws["noise"],
                                         ground_truth=draws["gt"])
            result.update(wall_s=time.perf_counter() - t, actions=run["actions"].tolist())
            if rank == 0:
                np.save(workdir / "final_cov.npy", run["final_cov"])
        if rank == 0:
            (workdir / "two_rank.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


def two_rank_run(workdir: pathlib.Path) -> dict:
    """Two subprocesses, one card, gloo; killed if they outlive their limit."""
    workdir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            out = open(workdir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--two-rank-worker", str(r),
                 str(workdir)], cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT), out))
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, TWO_RANK_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    for r, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            log((workdir / f"rank{r}.log").read_text()[-3000:])
        check(proc.returncode == 0, f"two-rank worker {r} exited with {proc.returncode}")
    result = json.loads((workdir / "two_rank.json").read_text())
    result["wall_s_with_start"] = time.perf_counter() - t0
    return result


def multidevice_phase() -> dict:
    """The multi-device path on the one card (phase 14)."""
    import torch.distributed as dist

    from ipp_rl_tpu_torch.parallel import initialize_multihost
    from ipp_rl_tpu_torch.parallel import large_grid

    log(f"== multi-device: world size 1 over NCCL; the 20x20 large-grid mission (float64, "
        f"{GRID_STEPS} steps) sharded against dense; the {LARGE_GRID_DIM}x{LARGE_GRID_DIM} one "
        f"(float32) timed; then two ranks on the card over gloo")
    mesh = initialize_multihost()
    out = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "mesh": list(mesh.shape)}
    try:
        world = IPPWorld(large_grid_cfg(20), dtype=torch.float64)
        gt, noise = grid_draws(world, torch.Generator(device="cuda").manual_seed(21))
        sharded = large_grid.sharded_greedy_mission(mesh, world, GRID_STEPS, noise=noise,
                                                    ground_truth=gt)
        dense = large_grid.dense_greedy_mission(world, GRID_STEPS, noise=noise, ground_truth=gt)
        check(len(sharded["actions"]) == GRID_STEPS, f"{len(sharded['actions'])} steps taken")
        check(np.array_equal(sharded["actions"], dense["actions"]),
              "sharded and dense 20x20 missions chose different actions")
        cov_err = float(np.abs(sharded["final_cov"] - dense["final_cov"]).max())
        mean_err = float(np.abs(sharded["final_mean"] - dense["final_mean"]).max())
        check(cov_err <= 1e-8 and mean_err <= 1e-8, f"20x20: cov {cov_err:.2e}, mean {mean_err:.2e}")
        check(sharded["uncertainty"][-1] < sharded["uncertainty"][0], "20x20: uncertainty rose")
        log(f"  20x20 (N 400, A 800): actions {sharded['actions'].tolist()} identical sharded and "
            f"dense; final cov max diff {cov_err:.2e}, mean {mean_err:.2e} (tolerance 1e-8)")
        out["grid20"] = {"actions": sharded["actions"].tolist(), "cov_err": cov_err,
                         "mean_err": mean_err, "uncertainty": sharded["uncertainty"].tolist()}

        t0 = time.perf_counter()
        big = IPPWorld(large_grid_cfg(LARGE_GRID_DIM))
        build_s = time.perf_counter() - t0
        N, (A, M) = LARGE_GRID_DIM ** 2, big.H.shape[:2]
        bgt, bnoise = grid_draws(big, torch.Generator(device="cuda").manual_seed(22))
        large_grid.dense_greedy_mission(big, 1, noise=bnoise, ground_truth=bgt)  # warm-up
        # the mission's set-up (the GP prior of an N x N belief) is timed apart
        meter = PartMeter()
        meter.wrap(big, "init_state", "init")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with traced() as snap:
            t0 = time.perf_counter()
            run = large_grid.sharded_greedy_mission(mesh, big, GRID_STEPS, noise=bnoise,
                                                    ground_truth=bgt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = len(run["actions"])
        init_s = meter.seconds["init"][0]
        wall -= init_s
        split = {part: sum(span_ms(snap[0], name)) / steps for part, name in (
            ("sweep", "grid.sweep"), ("commit", "grid.commit"),
            ("collectives", "grid.collective"))}
        check(steps == GRID_STEPS, f"{LARGE_GRID_DIM}x{LARGE_GRID_DIM}: {steps} steps taken")
        check(bool(np.isfinite(run["final_cov"]).all()), "large grid: non-finite covariance")
        check(run["uncertainty"][-1] < run["uncertainty"][0], "large grid: uncertainty rose")
        check(launches["spd_inverse"] == 2 * steps,
              "spd_inverse did not launch twice per step (the sweep's and the commit's)")
        t0 = time.perf_counter()
        dense_big = large_grid.dense_greedy_mission(big, GRID_STEPS, noise=bnoise,
                                                    ground_truth=bgt)
        torch.cuda.synchronize()
        dense_wall = time.perf_counter() - t0 - meter.seconds["init"][1]
        check(np.array_equal(run["actions"], dense_big["actions"]),
              f"{LARGE_GRID_DIM}x{LARGE_GRID_DIM}: sharded and dense chose different actions")
        log(f"  {LARGE_GRID_DIM}x{LARGE_GRID_DIM} (N {N}, A {A}, M {M}; world built in "
            f"{build_s:.1f} s, a mission's set-up {init_s:.2f} s): sharded "
            f"{wall / steps * 1e3:.1f} ms per step (sweep {split['sweep']:.1f}, commit "
            f"{split['commit']:.2f}, collectives {split['collectives']:.3f} ms by CUDA events, "
            f"nested), dense {dense_wall / steps * 1e3:.1f} ms per step, same actions; peak "
            f"{peak:.2f} GB; launches {launches}")
        out["grid_large"] = {"dim": LARGE_GRID_DIM, "N": N, "A": A, "M": M, "build_s": build_s,
                             "init_s": init_s,
                             "ms_per_step": wall / steps * 1e3, "split_ms": split,
                             "dense_ms_per_step": dense_wall / steps * 1e3, "peak_mem_gb": peak,
                             "uncertainty": [float(run["uncertainty"][0]),
                                             float(run["uncertainty"][-1])],
                             "actions": run["actions"].tolist()}
        out["launches"] = launches

        workdir = ROOT / "chiprun_out" / "multidevice"
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        torch.save({"gt": gt.cpu(), "noise": noise.cpu()}, workdir / "draws.pt")
        two = two_rank_run(workdir)
        if all(v == "ok" for v in two["probe"].values()):
            cov2 = np.load(workdir / "final_cov.npy")
            err2 = float(np.abs(cov2 - sharded["final_cov"]).max())
            check(two["actions"] == out["grid20"]["actions"],
                  "two ranks chose other actions than one")
            check(err2 <= 1e-8, f"two ranks: final cov differs by {err2:.2e}")
            two["cov_err_vs_one_rank"] = err2
            log(f"  two ranks on the card over gloo (CUDA tensors staged through the host): "
                f"20x20 actions identical to one rank's, final cov max diff {err2:.2e}; mission "
                f"{two['wall_s']:.1f} s, {two['wall_s_with_start']:.1f} s with the processes' start")
        else:
            log(f"  two ranks on the card over gloo: not run, gloo refused CUDA tensors for "
                + ", ".join(f"{k} ({v})" for k, v in two["probe"].items() if v != "ok"))
        out["two_ranks"] = two
    finally:
        dist.destroy_process_group()
    return out


# ------------------------------------------------------------ quality

def _d_stats(port: list, ref: list) -> dict:
    """d_i = port_i − ref_i over the matched worlds: its mean, its standard
    deviation and the bound 3·sd/√n that |mean d| must not pass."""
    d = np.asarray(port, dtype=np.float64) - np.asarray(ref, dtype=np.float64)
    sd = float(d.std(ddof=1)) if d.size > 1 else 0.0
    bound_ = float(3.0 * sd / np.sqrt(d.size))
    mean = float(d.mean())
    return {"mean_d": mean, "sd_d": sd, "bound": bound_, "ok": bool(abs(mean) <= bound_)}


def fine_grid_greedy(gen: torch.Generator, world=None, B: int = FINE_B,
                     steps: int = FINE_STEPS) -> dict:
    """The greedy mission on a finer grid (FINE_GRID's M = 25 unless a
    world is given) at B for ``steps`` steps with the kernels and with their
    plain versions, from one state and one injected noise."""
    if world is None:
        world = IPPWorld(grid_cfg(FINE_GRID), fast_sweeps=True)
    m = world.H.shape[1]
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    state0 = world.init_state(B, gen)
    noise = torch.randn((steps, B, m), generator=gen, device="cuda")
    torch.cuda.synchronize()
    launch = kernels.spd_trace_product_packed
    trace_events = []

    def timed_trace(S_packed, G_packed):  # CUDA events around each K2 launch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(S_packed, G_packed)
        end.record()
        trace_events.append((start, end))
        return out

    kernels.spd_trace_product_packed = timed_trace
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with_kernels = planner.run(B, steps, init_state=state0, noise=noise)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        kernels.spd_trace_product_packed = launch
    trace_ms = sum(s_.elapsed_time(e_) for s_, e_ in trace_events) / steps
    t0 = time.perf_counter()
    with plain_versions():
        plain = planner.run(B, steps, init_state=state0, noise=noise)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(kernels.launch_counts() == launches, "a kernel launched under plain_versions()")
    for name in ("spd_inverse", "spd_trace_product"):
        check(launches[name] > 0, f"{name} was not launched on the fine-grid greedy mission")
    check(np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True),
          "fine grid: the kernels and the plain versions chose different actions")
    for f in ("mean", "cov", "budget"):
        check(torch.equal(getattr(with_kernels.final_state, f), getattr(plain.final_state, f)),
              f"fine grid: the beliefs' {f} differ between kernels and plain versions")
    unc = with_kernels.metrics["uncertainty"].mean(axis=0)
    check(bool(np.all(np.diff(unc) < 0)), "fine grid: uncertainty does not fall step over step")
    log(f"  fine grid (M = {m}, A = {world.num_actions}, N = {world.H.shape[2]}), B = "
        f"{B} x {steps} steps: actions identical, beliefs bitwise equal; launches "
        f"{launches}; {kernel_s / steps * 1e3:.1f} ms per step with the kernels "
        f"(spd_trace_product {trace_ms:.3f} ms of it, CUDA events around its launches), "
        f"{plain_s / steps * 1e3:.1f} with the plain versions; mean uncertainty "
        f"{np.array2string(unc, precision=3)}")
    return {"batch": B, "steps": steps, "actions_identical": True,
            "beliefs_bitwise_equal": True, "launches": launches,
            "ms_per_step": kernel_s / steps * 1e3, "trace_product_ms_per_step": trace_ms,
            "plain_ms_per_step": plain_s / steps * 1e3, "mean_uncertainty": unc.tolist()}


def quality_curve(out_dir: pathlib.Path) -> dict:
    """(b) the quality tool's evaluation on the committed worlds at the
    committed JAX reference's settings, each row held to the reference
    mission by mission (|mean d| ≤ 3·sd(d)/√B for the final tr(P) and the
    final RMSE) and the rows' order by final tr(P) where the reference
    separates two rows by more than their bounds."""
    ref = json.loads(QUALITY_REFERENCE.read_text())
    check(ref["settings"] == qvr.REFERENCE_SETTINGS,
          "the committed JAX reference was made with other settings than the tool's")
    settings = qvr.Settings.from_reference(ref["settings"], root=str(ROOT))
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), fast_sweeps=True)
    init_state = qvr.load_worlds(str(QUALITY_WORLDS), world, settings.batch)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = qvr.evaluate(world, settings, init_state, log=lambda r: log("   ", r))
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name in ("spd_inverse", "spd_trace_product", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched on the quality curve")
    qvr.write_curve(str(out_dir / "curve"), {"settings": ref["settings"]}, rows,
                    torch.device("cuda"), str(QUALITY_WORLDS.relative_to(ROOT)))
    refs = {r["planner"]: r for r in ref["rows"]}
    table, failures = [], []
    for r in rows:
        jr = refs[r["planner"]]
        entry = {"planner": r["planner"], "port": {k: r[k] for k in qvr.JAX_ROW_KEYS},
                 "jax_final_uncertainty": jr["final_uncertainty"],
                 "jax_final_rmse": jr["final_rmse"], "jax_mean_steps": jr["mean_steps"]}
        for key in ("final_uncertainty", "final_rmse"):
            entry[key] = _d_stats(r["per_mission"][key], jr["per_mission"][key])
            if not entry[key]["ok"]:
                failures.append(f"{r['planner']} {key}: mean d {entry[key]['mean_d']:.4g} "
                                f"beyond 3 sd/sqrt(n) = {entry[key]['bound']:.4g}")
        table.append(entry)
        u, e = entry["final_uncertainty"], entry["final_rmse"]
        log(f"  (b) {r['planner']}: final tr(P) port {np.mean(r['per_mission']['final_uncertainty']):.4f}"
            f" jax {jr['final_uncertainty']:.4f} (mean d {u['mean_d']:+.4f}, bound {u['bound']:.4f}"
            f"); RMSE port {np.mean(r['per_mission']['final_rmse']):.5f} jax "
            f"{jr['final_rmse']:.5f} (mean d {e['mean_d']:+.5f}, bound {e['bound']:.5f}); steps "
            f"{r['mean_steps']} / {jr['mean_steps']:.2f}; {r['ms_per_replan']:.3f} ms per replan, "
            f"{r['wall_s']} s")
    order = []
    for i, a in enumerate(table):
        for b in table[i + 1:]:
            ja, jb = refs[a["planner"]]["final_uncertainty"], refs[b["planner"]]["final_uncertainty"]
            if abs(ja - jb) <= a["final_uncertainty"]["bound"] + b["final_uncertainty"]["bound"]:
                continue  # the reference does not separate these two
            pa = np.mean(next(r for r in rows if r["planner"] == a["planner"])
                         ["per_mission"]["final_uncertainty"])
            pb = np.mean(next(r for r in rows if r["planner"] == b["planner"])
                         ["per_mission"]["final_uncertainty"])
            same = (pa < pb) == (ja < jb)
            order.append({"pair": [a["planner"], b["planner"]], "same_order": bool(same)})
            if not same:
                failures.append(f"order of {a['planner']} and {b['planner']}: port "
                                f"{pa:.4f} / {pb:.4f}, jax {ja:.4f} / {jb:.4f}")
    result = {"settings": ref["settings"], "rows": table, "order": order,
              "launches": launches, "wall_s": wall}
    (out_dir / "comparison.json").write_text(json.dumps(result, indent=1))
    log(f"  (b) {len(order)} separated pairs in the reference's order: "
        f"{sum(o['same_order'] for o in order)}; launches {launches}; {wall:.1f} s")
    check(not failures, "quality against the JAX reference: " + "; ".join(failures))
    return result


def snapshot_eval(out_dir: pathlib.Path) -> dict:
    """(c) eval_snapshots on a copy of the committed run directory (the
    deployed checkpoint, 16 simulations, 8 steps, B = 32, the committed
    worlds): its deploy row equals the quality tool's zero_16sims row for the
    same worlds, steps and seed, both under deterministic algorithms."""
    run = out_dir / "run"
    (run / "checkpoints").mkdir(parents=True, exist_ok=True)
    shutil.copy(CHECKPOINT, run / "checkpoints" / CHECKPOINT.name)
    hp = qvr.REFERENCE_SETTINGS
    argv = ["--run", str(run), "--snapshots", "deploy", "--sims", str(SNAPSHOT_SIMS),
            "--eval-steps", str(SNAPSHOT_STEPS), "--batch", str(hp["batch"]),
            "--channels", str(hp["channels"]), "--blocks", str(hp["blocks"]),
            "--unfloored-value-head", "--worlds", str(QUALITY_WORLDS), "--device", "cuda"]
    settings = qvr.Settings(ckpt=str(CHECKPOINT), channels=hp["channels"], blocks=hp["blocks"],
                            batch=hp["batch"], max_steps=SNAPSHOT_STEPS,
                            zero_sims=str(SNAPSHOT_SIMS), unfloored_value_head=True,
                            rows=[f"zero_{SNAPSHOT_SIMS}sims"])
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), fast_sweeps=True)
    torch.backends.cudnn.benchmark = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        check(eval_snapshots.main(argv) == 0, "eval_snapshots exited non-zero")
        (row,) = qvr.evaluate(world, settings, qvr.load_worlds(str(QUALITY_WORLDS), world,
                                                               hp["batch"]), log=None)
    finally:
        torch.use_deterministic_algorithms(False)
    written = json.loads((run / "snapshot_eval_reference.json").read_text())
    check(list(written) == ["snapshot_deploy", "greedy", "random"],
          f"eval_snapshots wrote rows {list(written)}")
    deploy = written["snapshot_deploy"]
    for key in ("final_uncertainty", "final_rmse"):
        check(deploy[key] == row[key], f"eval_snapshots' deploy {key} {deploy[key]} differs "
                                       f"from the quality tool's {row[key]}")
    log(f"  (c) eval_snapshots deploy row {deploy} equals the quality tool's "
        f"zero_{SNAPSHOT_SIMS}sims row; greedy {written['greedy']}, random {written['random']}")
    return {"rows": written, "quality_tool_row": {k: row[k] for k in qvr.JAX_ROW_KEYS}}


def quality_phase() -> dict:
    log(f"== quality: the fine grid's greedy mission, the quality curve against the JAX "
        f"reference, eval_snapshots (allowance {QUALITY_ALLOWANCE_S} s)")
    out_dir = ROOT / "chiprun_out" / "quality"
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    parts = {}
    t = time.perf_counter()
    parts["fine_grid"] = fine_grid_greedy(gen)
    parts["fine_grid_s"] = time.perf_counter() - t
    t = time.perf_counter()
    parts["curve"] = quality_curve(out_dir)
    parts["curve_s"] = time.perf_counter() - t
    t = time.perf_counter()
    parts["snapshots"] = snapshot_eval(out_dir)
    parts["snapshots_s"] = time.perf_counter() - t
    log(f"  quality parts: fine grid {parts['fine_grid_s']:.1f} s, curve {parts['curve_s']:.1f} s, "
        f"eval_snapshots {parts['snapshots_s']:.1f} s")
    return parts


# ------------------------------------------------------------ the 1 m grid

def fine_1m_greedy(world) -> dict:
    """(a) the greedy mission on the 1 m grid, B = FINE_1M_B, FINE_1M_STEPS
    steps (a mission cut for time), counted from 0."""
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(16)
    planner.run(FINE_1M_B, max_steps=1, generator=gen)  # warm-up: handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tracing.reset(counters=TWO_STAGE)
    t0 = time.perf_counter()
    res = planner.run(FINE_1M_B, max_steps=FINE_1M_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, two_stage = kernels.launch_counts(), two_stage_calls()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"spd_inverse": FINE_1M_STEPS, "spd_inverse_factor": 0,
            "spd_trace_product": 2 * FINE_1M_STEPS, "edge_factor_gain": 0,
            "sweep_tap_blocks": 0}
    log(f"  (a) launches in the run: {launches} (want {want}); two-stage sweeps {two_stage}")
    check(launches == want, "the 1 m greedy launch counts differ from the stated ones")
    check(two_stage == FINE_1M_STEPS, "the 1 m sweeps did not take the two-stage route")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"1 m greedy: metric {k} not finite")
    unc = res.metrics["uncertainty"].mean(axis=0)
    check(bool(np.all(np.diff(unc) < 0)), "1 m greedy: uncertainty does not fall step over step")
    check(float(res.budgets.min()) >= 0.0, "1 m greedy: a budget went negative")
    state = res.final_state
    action = planner.plan(state, gen, 0)
    plan_ms = cuda_ms(lambda: planner.plan(state, gen, 0), 3, warmup=1)
    commit_ms = cuda_ms(lambda: world.step_index(state, action, generator=gen), 3, warmup=1)
    out = {"batch": FINE_1M_B, "steps": FINE_1M_STEPS, "run_wall_s": wall,
           "ms_per_step": wall / FINE_1M_STEPS * 1e3, "plan_ms": plan_ms, "commit_ms": commit_ms,
           "peak_mem_gb": peak, "mean_uncertainty": unc.tolist(), "launches": launches}
    log(f"  (a) 1 m greedy, B = {FINE_1M_B} x {FINE_1M_STEPS} steps: {out['ms_per_step']:.1f} "
        f"ms per step; sweep (plan) {plan_ms:.1f} ms, commit {commit_ms:.2f} ms; peak "
        f"{peak:.2f} GB; mean uncertainty {np.array2string(unc, precision=3)}")
    return out


def fine_1m_cmaes() -> dict:
    """(c) CMA-ES on temperature_cmaes.yaml at 1 m, B = FINE_1M_CMAES_B, one
    replan, counted from 0; then the kernels bitwise against the plain
    versions on the replan's own first ``edge_factor_gain`` inputs."""
    tcfg = grid_cfg(FINE_1M_GRID, "temperature_cmaes.yaml")
    t = time.perf_counter()
    world = IPPWorld(tcfg)
    built_s = time.perf_counter() - t
    check(world.m_max_cont == 121, f"the 1 m continuous M is {world.m_max_cont}, not 121")
    mc = cmaes_mission(tcfg)
    H, G, lam = mc.episode_horizon, mc.cma_maxiter, mc.cma_popsize
    planner = CMAESPlanner(world, mc)
    gen = torch.Generator(device="cuda").manual_seed(17)
    warm = CMAESPlanner(world, dataclasses.replace(mc, cma_maxiter=1))
    warm.run(FINE_1M_CMAES_B, max_steps=1, generator=gen)  # warm-up: cuBLAS, cuSOLVER
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch = kernels.edge_factor_gain
    captured = []

    def capture(*args):
        if not captured:
            captured.append(args)
        return launch(*args)

    kernels.reset_launch_counts()
    kernels.edge_factor_gain = capture
    try:
        t0 = time.perf_counter()
        res = planner.run(FINE_1M_CMAES_B, max_steps=1, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        kernels.edge_factor_gain = launch
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"edge_factor_gain": G * H + H, "spd_trace_product": H * 2, "spd_inverse": H + 1,
            "spd_inverse_factor": 0, "sweep_tap_blocks": 0}
    log(f"  (c) launches in the replan: {launches} (want {want})")
    check(launches == want, "the 1 m CMA-ES launch counts differ from the stated ones")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"1 m CMA-ES: metric {k} not finite")
    unc = res.metrics["uncertainty"].mean(axis=0)
    check(bool(unc[-1] < unc[0]), "1 m CMA-ES: uncertainty does not fall")
    check(float(res.budgets.min()) >= 0.0, "1 m CMA-ES: a budget went negative")
    split, fitness = cmaes_replan_split(planner, world, res.final_state, gen)
    args = captured[0]
    check(tuple(args[1].shape) == (FINE_1M_CMAES_B * lam, 121, 1600),
          f"the first fitness launch's A is {tuple(args[1].shape)}")
    errs = [compare(f"edge_factor_gain the replan's first fitness launch {tuple(args[1].shape)} "
                    f"({part})", got, want_)
            for got, want_, part in zip(launch(*args), smallchol.edge_factor_gain(*args),
                                        ("WcT", "gain"))]
    out = {"batch": FINE_1M_CMAES_B, "replans": 1, "popsize": lam, "generations": G,
           "horizon": H, "world_build_s": built_s, "run_wall_s": wall,
           "ms_per_replan": wall * 1e3, "peak_mem_gb": peak, "launches": launches,
           "replan_split_ms": split, "fitness_share": sum(fitness) / split["replan"],
           "fitness_call_ms": fitness, "mean_uncertainty": unc.tolist(),
           "captured_edge_max_abs_err": max(e["max_abs_err"] for e in errs)}
    log(f"  (c) 1 m CMA-ES, B = {FINE_1M_CMAES_B}, one replan: {wall * 1e3:.1f} ms (fitness "
        f"{out['fitness_share']:.0%} of the timed replan); peak {peak:.2f} GB; the world's "
        f"tables {built_s:.1f} s")
    return out


def fine_1m_phase() -> dict:
    log(f"== the 1 m grid: example.yaml and temperature_cmaes.yaml on {FINE_1M_GRID['x_dim']}x"
        f"{FINE_1M_GRID['y_dim']} cells of {FINE_1M_GRID['resolution']} m (lattice M = 81, "
        f"continuous M = 121; allowance {FINE_1M_ALLOWANCE_S} s)")
    parts = {}
    t = time.perf_counter()
    world, parts["world_build_s"] = fine_1m_world()
    parts["greedy"] = fine_1m_greedy(world)
    log("  (b) agreement:")
    parts["agreement"] = fine_grid_greedy(torch.Generator(device="cuda").manual_seed(18), world,
                                          FINE_1M_AGREE_B, 1)
    del world
    torch.cuda.empty_cache()
    parts["greedy_s"] = time.perf_counter() - t
    t = time.perf_counter()
    parts["cmaes"] = fine_1m_cmaes()
    parts["cmaes_s"] = time.perf_counter() - t
    log(f"  1 m parts: greedy and agreement {parts['greedy_s']:.1f} s (the world's tables "
        f"{parts['world_build_s']:.1f} s), CMA-ES {parts['cmaes_s']:.1f} s")
    return parts


def capture_edge_launches(keep):
    """A stand-in for kernels.edge_factor_gain that keeps the inputs of the
    launches ``keep(i)`` picks (i counts the launches) and launches the
    kernel; install it with ``swap_edge_launch``."""
    launch, captured, seen = kernels.edge_factor_gain, [], [0]

    def capture(*args):
        if keep(seen[0]):
            captured.append(args)
        seen[0] += 1
        return launch(*args)

    return capture, captured


@contextlib.contextmanager
def swap_edge_launch(stand_in):
    launch = kernels.edge_factor_gain
    kernels.edge_factor_gain = stand_in
    try:
        yield launch
    finally:
        kernels.edge_factor_gain = launch


def device_kernels_us(fn, calls: int = 10) -> dict:
    """Mean device µs per call of each kernel that fn() launches, by kernel
    name, from torch.profiler's device events; where the profiler cannot
    start, stop or record device events, what it said (a measurement, not a
    check: fn's own errors are raised)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"profile_error": f"start: {e}"}
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        events = prof.events()
    except RuntimeError as e:
        return {"profile_error": f"stop: {e}"}
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"\w+_kernel", e.name)
            name = found.group(0) if found else e.name[:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out or {"profile_error": "no device events"}


def edge_launch_check(args, launch) -> dict:
    """One recorded edge_factor_gain launch: both outputs bitwise against
    the plain version, then its device ms (CUDA graph), the bound, one
    library call and its kernels by the profiler."""
    want = smallchol.edge_factor_gain(*args)
    errs = [compare(f"edge_factor_gain {tuple(args[1].shape)} ({part})", g, w)
            for g, w, part in zip(launch(*args), want, ("WcT", "gain"))]
    B, m, n = args[1].shape
    t = {"ms": graph_ms(lambda: launch(*args), 20)}
    t["bound_ms"], t["bound_by"] = bound(edge_bytes(*args[:5]), B * edge_ops(
        m, n, masked=args[4] is not None, round_bf16=len(args) > 5 and bool(args[5])))
    t["library_ms"] = cuda_ms(lambda: library_edge_tail(*args[:5]), 5)
    t["max_abs_err"] = max(e["max_abs_err"] for e in errs)
    t["kernels_us"] = device_kernels_us(lambda: launch(*args))
    log(f"  edge_factor_gain {tuple(args[1].shape)}: {t['ms']:.4f} ms device; bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {t['library_ms']:.3f} ms; its "
        f"kernels (profiler, µs): {t['kernels_us']}")
    return t


def fine_2m_cmaes() -> dict:
    """(a) CMA-ES on temperature_cmaes.yaml at 2 m (continuous M = 25, N =
    400), B = FINE_2M_CMAES_B, one replan counted from 0; then the replan's
    first fitness launch (B·λ members, per-member mask) bitwise and timed."""
    tcfg = grid_cfg(FINE_GRID, "temperature_cmaes.yaml")
    world = IPPWorld(tcfg)
    check(world.m_max_cont == 25, f"the 2 m continuous M is {world.m_max_cont}, not 25")
    mc = cmaes_mission(tcfg)
    H, G, lam = mc.episode_horizon, mc.cma_maxiter, mc.cma_popsize
    B = FINE_2M_CMAES_B
    planner = CMAESPlanner(world, mc)
    gen = torch.Generator(device="cuda").manual_seed(19)
    warm = CMAESPlanner(world, dataclasses.replace(mc, cma_maxiter=1))
    warm.run(B, max_steps=1, generator=gen)  # warm-up: cuBLAS, cuSOLVER, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture, captured = capture_edge_launches(lambda i: i == 0)
    with swap_edge_launch(capture) as launch:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = planner.run(B, max_steps=1, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"edge_factor_gain": G * H + H, "spd_trace_product": H * 2, "spd_inverse": H + 1,
            "spd_inverse_factor": 0, "sweep_tap_blocks": 0}
    log(f"  (a) launches in the replan: {launches} (want {want})")
    check(launches == want, "the 2 m CMA-ES launch counts differ from the stated ones")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"2 m CMA-ES: metric {k} not finite")
    unc = res.metrics["uncertainty"].mean(axis=0)
    check(bool(unc[-1] < unc[0]), "2 m CMA-ES: uncertainty does not fall")
    check(float(res.budgets.min()) >= 0.0, "2 m CMA-ES: a budget went negative")
    split, fitness = cmaes_replan_split(planner, world, res.final_state, gen)
    args = captured[0]
    check(tuple(args[1].shape) == (B * lam, 25, 400) and args[4] is not None
          and tuple(args[4].shape) == (B * lam, 400),
          f"the first fitness launch's A is {tuple(args[1].shape)}, its mask "
          f"{None if args[4] is None else tuple(args[4].shape)}")
    edge = edge_launch_check(args, launch)
    out = {"batch": B, "replans": 1, "popsize": lam, "generations": G, "horizon": H,
           "run_wall_s": wall, "ms_per_replan": wall * 1e3, "peak_mem_gb": peak,
           "launches": launches, "replan_split_ms": split,
           "fitness_share": sum(fitness) / split["replan"], "fitness_call_ms": fitness,
           "mean_uncertainty": unc.tolist(), "first_fitness_edge": edge}
    log(f"  (a) 2 m CMA-ES, B = {B}, one replan: {wall * 1e3:.1f} ms (fitness "
        f"{out['fitness_share']:.0%} of the timed replan); peak {peak:.2f} GB")
    return out


def fine_2m_zero() -> dict:
    """(b) the MCTS-zero deploy search on example.yaml at 2 m (lattice M =
    25, A = 800, N = 400) at full width with seeded weights, B =
    FINE_2M_ZERO_B, one replan counted from 0 after a warm-up at 2
    simulations and split by CUDA events; one descent step's edge inputs
    bitwise and timed."""
    cfg = grid_cfg(FINE_GRID)
    mc = zero_mission(cfg)
    hp = mc.hyper_params
    sims, B = hp.num_mcts_simulations, FINE_2M_ZERO_B
    world = IPPWorld(cfg)
    check(world.H.shape[1] == 25 and world.num_actions == 800,
          f"the 2 m lattice has M = {world.H.shape[1]}, A = {world.num_actions}")
    gen = torch.Generator(device="cuda").manual_seed(20)
    net = init_network(cfg, hp, gen)
    predict = predict_fn(net, dtype=inference_dtype(hp))
    ZeroPlanner(world, zero_mission(cfg, num_mcts_simulations=2), predict,
                net.state_dict()).run(B, max_steps=1, generator=gen)  # warm-up
    planner = ZeroPlanner(world, mc, predict, net.state_dict(), deploy_mode="reference")
    visits = RootVisits(planner)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture, captured = capture_edge_launches(lambda i: i == 50)
    with swap_edge_launch(capture) as launch, traced() as snap:
        t0 = time.perf_counter()
        res = planner.run(B, max_steps=1, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    steps = snap[0].counters["zero.descent_steps"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  (b) launches in the replan: {launches}; descent steps {steps}")
    check(launches["edge_factor_gain"] == steps > 0,
          "2 m zero: edge_factor_gain did not launch once per descent step")
    check(launches["spd_inverse_factor"] == 0, "2 m zero: spd_inverse_factor launched")
    root_ns = torch.stack(visits.Ns)
    check(len(visits.Ns) == 1 and bool((root_ns == sims - 1).all()),
          f"2 m zero: root visit totals {root_ns.min().item():g}..{root_ns.max().item():g}, "
          f"want {sims - 1}")
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"2 m zero: metric {k} not finite")
    check(len(captured) == 1 and tuple(captured[0][1].shape) == (B, 25, 400),
          "2 m zero: the descent step's edge inputs were not recorded")
    split = zero_split(snap[0])
    edge = edge_launch_check(captured[0], launch)
    out = {"batch": B, "replans": 1, "simulations": sims, "channels": hp.num_channels,
           "encoder_blocks": hp.num_encoder_res_blocks, "run_wall_s": wall,
           "ms_per_replan": wall * 1e3, "peak_mem_gb": peak, "launches": launches,
           "descent_steps": steps,
           "root_visits": [root_ns.min().item(), root_ns.max().item()],
           "replan_split_ms": split, "descent_step_edge": edge,
           "mean_uncertainty": res.metrics["uncertainty"].mean(axis=0).tolist()}
    log(f"  (b) 2 m zero, B = {B}, one replan: {wall * 1e3:.1f} ms, {steps} descent steps; "
        f"peak {peak:.2f} GB")
    return out


def fine_2m_phase() -> dict:
    log(f"== the 2 m grid's CMA-ES and MCTS-zero: temperature_cmaes.yaml and example.yaml on "
        f"{FINE_GRID['x_dim']}x{FINE_GRID['y_dim']} cells of {FINE_GRID['resolution']} m "
        f"(M = 25, N = 400; allowance {FINE_2M_ALLOWANCE_S} s)")
    parts = {}
    t = time.perf_counter()
    parts["cmaes"] = fine_2m_cmaes()
    parts["cmaes_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    parts["zero"] = fine_2m_zero()
    parts["zero_s"] = time.perf_counter() - t
    log(f"  2 m parts: CMA-ES {parts['cmaes_s']:.1f} s, zero {parts['zero_s']:.1f} s")
    return parts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # temperature_cmaes.yaml's ground truth is the repository's dataset
    os.environ.setdefault("DATASETS_DIR", str(ROOT / "datasets"))
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    lib_path = kernels.build()
    build_s = time.perf_counter() - t0
    part_s = list(kernels.part_seconds)
    log(f"build: {lib_path.name} in {build_s:.1f} s (nvcc {kernels.build_seconds:.1f} s; "
        f"{kernels.PARTS} parts ended at {[round(t, 1) for t in part_s]} s)")
    t0 = time.perf_counter()
    traj_lib = pathlib.Path(trajgen.build_library())
    build_s += time.perf_counter() - t0
    log(f"build: {traj_lib.name} (g++ {' '.join(trajgen.GXX_FLAGS)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    report = lib_path.with_suffix(".log")
    if report.exists():  # the compiler's register/spill report for the M = 9 f32 kernels
        show = False
        for line in report.read_text().splitlines():
            if "Compiling entry function" in line:
                show = "ILi9EfE" in line
            if show:
                log("  ptxas:", line.strip())

    phase_s = {}  # host seconds of each phase, to show where the script's time goes

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = timed("kernels", kernel_phase, gen)
    # the graph capture of the parent's edge tail leaves a cuBLAS workspace
    # (32 MiB) on its side stream; release it so the slices' peaks count
    # only their own memory
    torch._C._cuda_clearCublasWorkspaces()
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    greedy = timed("greedy", greedy_phase, cfg)
    agreement = timed("greedy_agreement", agreement_phase, cfg)
    zero = timed("zero", zero_phase, cfg)
    zero_agreement = timed("zero_agreement", zero_agreement_phase, cfg)
    training = timed("training", training_phase, cfg)
    training_agreement = timed("training_agreement", training_agreement_phase, cfg)
    static = timed("static", static_phase, cfg)
    tcfg = load_config(str(CONFIG_DIR / "temperature_cmaes.yaml"))
    cmaes_run = timed("cmaes", cmaes_phase, tcfg)
    cmaes_agreement = timed("cmaes_agreement", cmaes_agreement_phase, tcfg)
    classic = timed("classic", classic_phase, cfg)
    classic_agreement = timed("classic_agreement", classic_agreement_phase, cfg)
    entry_points = timed("entry_points", entry_points_phase)
    deploy = timed("deploy", deploy_phase, cfg)
    multidevice = timed("multidevice", multidevice_phase)
    quality = timed("quality", quality_phase)
    fine_1m = timed("fine_1m", fine_1m_phase)
    fine_2m = timed("fine_2m", fine_2m_phase)
    pr6_s = phase_s["static"] + phase_s["cmaes"] + phase_s["cmaes_agreement"]
    pr7_s = phase_s["classic"] + phase_s["classic_agreement"] + phase_s["entry_points"]
    pr8_s = phase_s["deploy"] + phase_s["multidevice"]
    log(f"phase seconds: build {build_s:.1f}, " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; training: learn {training['learn_wall_s']:.1f}, fixed-batch check "
        f"{training['loss_check_s']:.1f}, arena gate {training['arena_wall_s']:.1f}; "
        f"static + cmaes + cmaes_agreement {pr6_s:.1f} (allowance 60); "
        f"classic + classic_agreement + entry_points {pr7_s:.1f} (allowance 120); "
        f"deploy + multidevice {pr8_s:.1f} (allowance {NEW_PHASES_ALLOWANCE_S}); "
        f"quality {phase_s['quality']:.1f} (allowance {QUALITY_ALLOWANCE_S}); "
        f"fine_1m {phase_s['fine_1m']:.1f} (allowance {FINE_1M_ALLOWANCE_S}); "
        f"fine_2m {phase_s['fine_2m']:.1f} (allowance {FINE_2M_ALLOWANCE_S})")
    for r in rows:  # over the main paths, each counted from 0
        r["launches_by_path"] = {"greedy": greedy["launches"][r["name"]],
                                 "zero": zero["launches"][r["name"]],
                                 "train": training["launches"][r["name"]],
                                 "static": static["launches"][r["name"]],
                                 "cmaes": cmaes_run["launches"][r["name"]],
                                 "classic": classic["launches"][r["name"]],
                                 "experiment": entry_points["launches"][r["name"]],
                                 "deploy": deploy["launches"][r["name"]],
                                 "multidevice": multidevice["launches"][r["name"]],
                                 "fine_grid": quality["fine_grid"]["launches"][r["name"]],
                                 "quality": quality["curve"]["launches"][r["name"]],
                                 "fine_1m_greedy": fine_1m["greedy"]["launches"][r["name"]],
                                 "fine_1m_cmaes": fine_1m["cmaes"]["launches"][r["name"]],
                                 "fine_2m_cmaes": fine_2m["cmaes"]["launches"][r["name"]],
                                 "fine_2m_zero": fine_2m["zero"]["launches"][r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "build_part_s": part_s,
        "phase_s": phase_s, "kernels": rows,
        "greedy": greedy, "agreement": agreement, "zero": zero,
        "zero_agreement": zero_agreement, "training": training,
        "training_agreement": training_agreement, "static": static, "cmaes": cmaes_run,
        "cmaes_agreement": cmaes_agreement, "classic": classic,
        "classic_agreement": classic_agreement, "entry_points": entry_points,
        "deploy": deploy, "multidevice": multidevice, "quality": quality, "fine_1m": fine_1m,
        "fine_2m": fine_2m,
    }, indent=1))

    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "m_range",
            "m25", "m81_m121")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-rank-worker"]:
        sys.exit(two_rank_worker(int(sys.argv[2]), pathlib.Path(sys.argv[3])))
    sys.exit(main())
