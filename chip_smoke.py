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
   ``TRAIN_ENVS``;
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
   ``spd_trace_product`` on the greedy init's sweep at B = 1024.

Float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The last stdout line is ``{"ok": true, "device": {...}}``;
the lines before it carry the per-kernel JSON and the card.  A fuller
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.models.networks import plane_channels
from ipp_rl_tpu_torch.planners import (
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
CHECKPOINT = ROOT / "runs" / "zero_canon_r5_best" / "checkpoints" / "shared_net.trained_model.ckpt"
# the committed checkpoint's hyper-parameters (tests/test_learning_artifact.py)
CHECKPOINT_HP = dict(num_channels=64, num_encoder_res_blocks=6, num_global_pooling_channels=32,
                     max_valid_action_distance=11.5, unfloored_value_head=True)
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

def random_spd(n: int, gen: torch.Generator) -> torch.Tensor:
    A = torch.randn((n, M, M), generator=gen, device="cuda")
    return A @ A.mT + 0.5 * torch.eye(M, device="cuda")


def make_indefinite(S: torch.Tensor) -> torch.Tensor:
    """S with its last pivot driven negative, so the kernels clamp it."""
    S = S.clone()
    S[..., -1, -1] -= 2.0 * S.diagonal(dim1=-2, dim2=-1).sum(-1)
    return S


def packed(S: torch.Tensor, outer: int, inner: int) -> torch.Tensor:
    """(outer * inner, M, M) blocks → the kernel's (outer, T, inner) layout."""
    return smallchol.pack_lower(S).view(outer, inner, T).transpose(1, 2).contiguous()


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
    layouts = {  # name: (outer, inner), as ops/kalman.py builds them
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
    for r in rows:
        if r["name"] in continuous:
            r["continuous_checks"] = continuous[r["name"]]
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
    return WcT, torch.sum(torch.sum(WcT * WcT, dim=-2) * mask, dim=-1)


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

    def waypoints(w, n):
        env, con = w.cfg.environment, w.cfg.constraints
        lo = torch.tensor([0.0, 0.0, con.min_altitude], device="cuda")
        hi = torch.tensor([env.extent_x, env.extent_y, con.max_altitude], device="cuda")
        return lo + torch.rand((n, 3), generator=gen, device="cuda") * (hi - lo)

    state = world.init_state(STATIC_B, gen)
    wp = waypoints(world, STATIC_B)
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
        Hn, Rn, _, _ = tworld.measurement_model_at(waypoints(tworld, n))
        An = Hn @ P
        args = (An @ Hn.mT, An, Rn, torch.arange(n, device="cuda"), m)
        for got, want, part in zip(kernels.edge_factor_gain(*args),
                                   smallchol.edge_factor_gain(*args), ("WcT", "gain")):
            errs.append(compare(f"edge_factor_gain B*lambda={n} per-sample R, mask ({part})",
                                got, want))
        del P, An, args
    out["edge_factor_gain"] = {k: max(e[k] for e in errs) for k in errs[0]}

    recorded = []
    launch = kernels.spd_trace_product_packed

    def record(S_packed, G_packed):
        recorded.append((S_packed, G_packed))
        return launch(S_packed, G_packed)

    record.launches = 0  # the wrapper counts its launch on the name it is bound to
    kernels.spd_trace_product_packed = record
    try:
        sweep_rewards(tworld, tworld.init_state(CMAES_B, gen))
    finally:
        kernels.spd_trace_product_packed = launch
    errs = [compare(f"spd_trace_product greedy init {tuple(Sp.shape)}",
                    kernels.spd_trace_product_packed(Sp, Gp),
                    smallchol.spd_trace_product_packed(Sp, Gp)) for Sp, Gp in recorded]
    check(len(recorded) == 2, f"{len(recorded)} trace-product launches in one sweep")
    out["spd_trace_product"] = {k: max(e[k] for e in errs) for k in errs[0]}
    return out


# ------------------------------------------------------------ greedy slice

KERNEL_NAMES = {  # wrapper attribute: name in the report
    "spd_inverse": "spd_inverse",
    "spd_inverse_factor": "spd_inverse_factor",
    "spd_trace_product_packed": "spd_trace_product",
    "edge_factor_gain": "edge_factor_gain",
}


def launch_counts() -> dict:
    return {name: getattr(kernels, attr).launches for attr, name in KERNEL_NAMES.items()}


@contextlib.contextmanager
def plain_versions():
    """Route the sweep, the commit and the edge update through the plain
    versions (for the comparison only; the port itself has no such
    switch)."""
    saved = {attr: getattr(kernels, attr) for attr in KERNEL_NAMES}
    for attr in KERNEL_NAMES:
        setattr(kernels, attr, getattr(smallchol, attr))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(kernels, attr, fn)


def greedy_phase(cfg) -> dict:
    log(f"== greedy slice: example.yaml, fast_sweeps, B={REPLAN_B}, {REPLAN_STEPS} steps")
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    planner.run(REPLAN_B, max_steps=1, generator=gen)  # warm-up: handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = planner.run(REPLAN_B, max_steps=REPLAN_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"  launches in the run: {launches}")
    for name in ("spd_inverse", "spd_trace_product"):
        check(launches[name] > 0, f"{name} was not launched on the greedy path")

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
        "launches": launches,
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
def count_calls(owner, attr: str):
    """Counts the calls of ``owner.attr`` in a one-element list while the
    block runs: an instance's method, or a class's (then every instance's,
    those made inside the block too)."""
    own = vars(owner).get(attr)
    fn, calls = getattr(owner, attr), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    setattr(owner, attr, counted)
    try:
        yield calls
    finally:
        if own is None:
            delattr(owner, attr)
        else:
            setattr(owner, attr, own)


class PhaseTimer:
    """Device time of named phases of one replan: CUDA events recorded
    around each call of the wrapped methods, summed after a synchronise."""

    def __init__(self):
        self.events = {}

    def wrap(self, obj, attr: str, phase: str) -> None:
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.setdefault(phase, []).append((start, end))
            return out

        if hasattr(fn, "infer_dtype"):
            timed.infer_dtype = fn.infer_dtype
        setattr(obj, attr, timed)

    def calls_ms(self, phase: str) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[phase]]

    def ms(self) -> dict:
        return {k: sum(self.calls_ms(k)) for k in self.events}


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

    with count_calls(planner.mcts, "_descend_step") as steps:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = planner.run(ZERO_B, max_steps=ZERO_STEPS, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches in the run: {launches}; descent steps {steps[0]}")
    for name in ("spd_inverse", "edge_factor_gain"):
        check(launches[name] > 0, f"{name} was not launched on the zero path")
    check(launches["edge_factor_gain"] == steps[0],
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

    # one more steady replan, split into phases by CUDA events
    state = res.final_state
    hist = init_history(cfg, hp, ZERO_B, world.dtype, world.device)
    hist = push_history(hist, state.cov, state.pos, state.budget / cfg.constraints.budget)
    timer = PhaseTimer()
    mcts = planner.mcts
    timer.wrap(mcts, "_descend_step", "descent")
    timer.wrap(mcts, "_leaf_outputs", "leaf_planes")
    timer.wrap(mcts, "leaf_planes", "leaf_planes")
    timer.wrap(mcts, "predict", "forward")
    timer.wrap(mcts, "_integrate_eval", "integrate_backup")
    timer.wrap(mcts, "_backup", "integrate_backup")
    timer.wrap(planner, "_replan", "replan")
    planner._replan(state, hist, gen, None)
    split = timer.ms()
    split["other"] = split["replan"] - sum(v for k, v in split.items() if k != "replan")
    log("  one replan by CUDA events: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
    n = cfg.environment.num_cells
    flops = network_flops(net, torch.zeros((ZERO_B, n, n, plane_channels(hp)), device=world.device),
                          torch.ones((ZERO_B, world.num_actions), device=world.device))
    forwards = len(timer.events["forward"])
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
        "descent_steps": steps[0],
        "replan_split_ms": split,
        "forward_flops": flops, "forward_ms": split["forward"] / forwards,
        "forward_tflops_per_s": tflops,
    }
    log(f"  run: {out['ms_per_step']:.1f} ms per replan step, {out['replans_per_s']:.1f} "
        f"replans/s, {out['ms_per_mission_replan']:.3f} ms per mission-replan; "
        f"peak {peak:.2f} GB")
    return out


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
        launches = launch_counts()
        with plain_versions():
            plain = run()
        check(launch_counts() == launches, "a kernel launched under plain_versions()")
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
        with count_calls(world, "step_index") as commits, \
                count_calls(ZeroMCTS, "_descend_step") as descents:
            # the self-play searches split by CUDA events, as phase 5 splits a replan
            timer = PhaseTimer()
            for attr, part in (("_descend_step", "descent"), ("_leaf_outputs", "leaf_planes"),
                               ("leaf_planes", "leaf_planes"), ("predict", "forward"),
                               ("_integrate_eval", "integrate_backup"),
                               ("_backup", "integrate_backup")):
                timer.wrap(learner.mcts, attr, part)
            timer.wrap(learner.selfplay, "run", "selfplay")
            timer.wrap(learner, "train_iteration", "train")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            learner.learn(num_iterations=TRAIN_ITERATIONS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
        split = timer.ms()
        split["selfplay_other"] = split["selfplay"] - sum(
            split[k] for k in ("descent", "leaf_planes", "forward", "integrate_backup"))
        selfplay_steps = commits[0]
        log(f"  learn by CUDA events, over {selfplay_steps} self-play steps: "
            + ", ".join(f"{k} {v:.0f} ms" for k, v in split.items()))
        log(f"  learn: {wall:.1f} s; launches {launches}; descent steps {descents[0]}, "
            f"self-play steps {selfplay_steps}")
        check(selfplay_steps == TRAIN_ITERATIONS * TRAIN_EPISODE_STEPS,
              f"{selfplay_steps} self-play commits for {TRAIN_ITERATIONS} x "
              f"{TRAIN_EPISODE_STEPS} steps")
        for name in ("spd_inverse", "edge_factor_gain"):
            check(launches[name] > 0, f"{name} was not launched on the training path")
        check(launches["edge_factor_gain"] == descents[0] + selfplay_steps,
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
        with count_calls(ZeroMCTS, "_descend_step") as arena_descents:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            accepted = learner.arena_gate(prev, ARENA_GAMES)
            torch.cuda.synchronize()
            arena_wall = time.perf_counter() - t0
            arena_launches = launch_counts()
        arena_steps = 2 * ARENA_STEPS
        log(f"  arena gate: {ARENA_GAMES} games x {ARENA_STEPS} steps per network, "
            f"accepted={accepted}, {arena_wall:.1f} s; launches {arena_launches}; descent steps "
            f"{arena_descents[0]}")
        check(arena_launches["edge_factor_gain"] == arena_descents[0] + arena_steps,
              "edge_factor_gain did not launch once per arena descent step and game step")
        check(arena_launches["spd_inverse_factor"] == 0, "spd_inverse_factor launched in the arena")

    # self-play is SelfPlay.run alone, in the second iteration (no first-call
    # set-up); the learner's selfplay_s also holds the trajectory's copy to
    # the host, add_iteration and the npz write: the learner loop's I/O
    sp_s = meter.seconds["selfplay"][-1]
    sp_event_ms = timer.calls_ms("selfplay")[-1]
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
        "descent_steps": descents[0], "selfplay_steps": selfplay_steps, "moved": moved,
        "learn_split_ms": split,
        "arena_descent_steps": arena_descents[0], "arena_steps": arena_steps,
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
        launches = launch_counts()
        with plain_versions():
            plain = run()
        check(launch_counts() == launches, "a kernel launched under plain_versions()")
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
        counts = launch_counts()
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
    t0 = time.perf_counter()
    res = planner.run(CMAES_B, max_steps=CMAES_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"edge_factor_gain": CMAES_STEPS * (G * H + H),
            "spd_trace_product": CMAES_STEPS * H * 2,
            "spd_inverse": CMAES_STEPS * (H + 1), "spd_inverse_factor": 0}
    log(f"  launches in the run: {launches} (want {want})")
    check(launches == want, "CMA-ES launch counts differ from the stated ones")
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

    # one more replan and its commit, split by CUDA events
    state = res.final_state
    timer = PhaseTimer()
    parts = ((cmaes, "greedy_search_horizon", "greedy_init"), (cmaes, "cma_es_minimize", "cma"),
             (planner, "trajectory_loss", "fitness"), (planner, "eigh", "eigh"),
             (planner, "replan_batch", "replan"), (world, "step_position", "commit"))
    saved = [(obj, attr, vars(obj).get(attr)) for obj, attr, _ in parts]
    for obj, attr, part in parts:
        timer.wrap(obj, attr, part)
    try:
        wps_next, valid = planner.replan_batch(state, generator=gen)
        world.step_position(state.replace(active=state.active & valid), wps_next[:, 0],
                            generator=gen)
        fitness = timer.calls_ms("fitness")  # G inside CMA-ES, then the greedy plan's
        split = timer.ms()
    finally:
        for obj, attr, own in saved:  # a module's or instance's own, else the class's
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
    split["cma_update"] = split["cma"] - sum(fitness[:-1])
    split["other"] = split["replan"] - split["greedy_init"] - split["cma"] - fitness[-1]
    log("  one replan by CUDA events: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; {len(fitness)} fitness calls, {np.mean(fitness):.2f} ms each")
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
    launches = launch_counts()
    with plain_versions():
        plain = run()
    check(launch_counts() == launches, "a kernel launched under plain_versions()")
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
    log(f"build: {lib_path.name} in {build_s:.1f} s (nvcc {kernels.build_seconds:.1f} s)")
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
    new_s = phase_s["static"] + phase_s["cmaes"] + phase_s["cmaes_agreement"]
    log(f"phase seconds: build {build_s:.1f}, " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; training: learn {training['learn_wall_s']:.1f}, fixed-batch check "
        f"{training['loss_check_s']:.1f}, arena gate {training['arena_wall_s']:.1f}; "
        f"static + cmaes + cmaes_agreement {new_s:.1f} (allowance 60)")
    for r in rows:  # over the main paths, each counted from 0
        r["launches_by_path"] = {"greedy": greedy["launches"][r["name"]],
                                 "zero": zero["launches"][r["name"]],
                                 "train": training["launches"][r["name"]],
                                 "static": static["launches"][r["name"]],
                                 "cmaes": cmaes_run["launches"][r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "phase_s": phase_s, "kernels": rows,
        "greedy": greedy, "agreement": agreement, "zero": zero,
        "zero_agreement": zero_agreement, "training": training,
        "training_agreement": training_agreement, "static": static, "cmaes": cmaes_run,
        "cmaes_agreement": cmaes_agreement,
    }, indent=1))

    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
