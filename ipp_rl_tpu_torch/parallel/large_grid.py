"""End-to-end large-grid greedy mission through the mp-sharded Kalman ops.

Port of ``ipp_rl_tpu/parallel/large_grid.py``.  The covariance-sharding
operations (parallel/sharded_kalman.py) exist for grids whose N×N
covariance outgrows one device (reference mapping/mappings.py:226-233
builds the same N×N Matérn prior densely).  This module RUNS a mission on
that path: a greedy replan loop (reference
planning/greedy_mission.py:73-110) where

  * the all-action candidate sweep is sharded over the ACTION axis
    (``sharded_sweep_gains``: each rank prices A/d actions), and
  * the measurement commit is sharded over the COVARIANCE ROWS
    (``sharded_kf_update``: each rank keeps its N/d rows).

Between steps each rank holds its rows; the sweep, the adaptive mask and
the recorded tr(P) and RMSE read the whole P and mean, which one
all_gather each brings (the JAX package's replicated in_spec does the
same implicitly).  ``dense_greedy_mission`` is the identical loop on one
device with the dense ``kf_sweep_gains`` and the Joseph ``kf_update``:
the exact-match oracle.  Every call is eager, so a step launches a fixed
set of kernels: ``spd_inverse`` twice (the sweep's and the commit's).

The measurement noise comes from ``generator`` (seeded alike on every
rank, so z is replicated) or is injected as ``noise`` (T, M); the JAX
package draws it with ``fold_in(key, step)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains, kf_update
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask, reward_from_gain
from ipp_rl_tpu_torch.parallel.sharded_kalman import (
    all_gather_rows,
    sharded_kf_update,
    sharded_sweep_gains,
)
from ipp_rl_tpu_torch.planners.base import action_costs_from


def _greedy_loop(
    world: IPPWorld,
    max_steps: int,
    generator: Optional[torch.Generator],
    noise: Optional[torch.Tensor],
    ground_truth: Optional[torch.Tensor],
    rows: slice,
    sweep: Callable,
    commit: Callable,
    gather: Callable,
) -> Dict[str, np.ndarray]:
    """The greedy mission of one grid: ``rows`` of P and the mean are this
    rank's, ``gather`` returns the whole (P, mean) from them, ``sweep``
    prices every action against the whole P, ``commit`` updates the rows."""
    cfg = world.cfg
    state = world.init_state(1, generator, ground_truth=ground_truth)
    P, mean = state.cov[0, rows].clone(), state.mean[0, rows].clone()
    gt, pos, budget = state.ground_truth[0], state.pos[0], state.budget[0]
    del state
    P_full, mean_full = gather(P, mean)

    actions, uncs, rmses = [], [], []

    def record():
        uncs.append(torch.trace(P_full))
        rmses.append(torch.sqrt(torch.mean(torch.square(gt - mean_full))))

    record()
    for step in range(max_steps):
        mask = torch.ones_like(mean_full)
        if cfg.scenario.adaptive:
            mask = adaptive_mask(mean_full, torch.diagonal(P_full), cfg.scenario.value_threshold,
                                 cfg.scenario.interval_factor)
        gains = sweep(P_full, mask)
        costs = action_costs_from(world, pos)
        rewards = reward_from_gain(gains, costs)
        ok = (costs > 0) & (costs <= budget)
        scored = torch.where(ok, rewards, float("-inf"))
        if not bool(torch.any(ok)):
            break
        a = int(torch.argmax(scored))
        z = world.synthesize_measurement(
            gt[None], world.Z[a][None], world.noise_std[a][None],
            None if noise is None else noise[step][None], generator,
        )[0]
        mean, P = commit(P, mean, world.H[a], world.R_diag[a], z)
        P_full, mean_full = gather(P, mean)
        budget = budget - costs[a]
        pos = world.actions_xyz[a]
        actions.append(a)
        record()

    return {
        "actions": np.asarray(actions, np.int32),
        "uncertainty": torch.stack(uncs).cpu().numpy(),
        "rmse": torch.stack(rmses).cpu().numpy(),
        "final_mean": mean_full.cpu().numpy(),
        "final_cov": P_full.cpu().numpy(),
        "budget_left": float(budget),
    }


def sharded_greedy_mission(
    mesh: DeviceMesh,
    world: IPPWorld,
    max_steps: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    ground_truth: Optional[torch.Tensor] = None,
) -> Dict[str, np.ndarray]:
    """One greedy mission with every O(N²)/O(A·N²) operation on the mesh's
    mp axis; every rank of it calls this with the same world, draws and
    arguments.  Single mission by design: mp is for grids where one N×N
    covariance is the scaling unit (batching is dp's job).  Returns the
    per-step actions, tr(P) and RMSE curves, the final belief and the
    budget left (host numpy), the same on every rank."""
    group = mesh.get_group("mp")
    d, r = mesh["mp"].size(), mesh.get_local_rank("mp")
    N = world.cfg.environment.num_cells
    if N % d:
        raise ValueError(f"N = {N} does not divide over mp = {d}")
    n_loc = N // d

    def gather(P, mean):
        return all_gather_rows(P, group, d), all_gather_rows(mean, group, d)

    return _greedy_loop(
        world, max_steps, generator, noise, ground_truth,
        rows=slice(r * n_loc, (r + 1) * n_loc),
        sweep=lambda P, mask: sharded_sweep_gains(mesh, P, world.H, world.R_diag, mask),
        commit=lambda P, mean, H, R, z: sharded_kf_update(mesh, P, mean, H, R, z),
        gather=gather,
    )


def dense_greedy_mission(
    world: IPPWorld,
    max_steps: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    ground_truth: Optional[torch.Tensor] = None,
) -> Dict[str, np.ndarray]:
    """The identical loop on one device (dense ``kf_sweep_gains``, Joseph
    ``kf_update``) with the same noise: the exact-match oracle and the
    single-device timing reference."""
    return _greedy_loop(
        world, max_steps, generator, noise, ground_truth,
        rows=slice(None),
        sweep=lambda P, mask: kf_sweep_gains(P, world.H, world.R_diag, mask),
        commit=kf_update,
        gather=lambda P, mean: (P, mean),
    )

