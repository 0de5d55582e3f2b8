"""Planner base: the mission loop shared by every planner.

Port of ``ipp_rl_tpu/planners/base.py``.  The JAX package's ``lax.scan``
over a static step bound becomes a Python loop with per-mission active
masks: missions that exhaust their budget keep carrying state but stop
measuring (mask-and-continue), so metric histories stay rectangular
(B, T+1).  Histories stay on the device and move to the host once, at
the end of the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config, MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains_batched
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask, reward_from_gain


def action_costs_from(world: IPPWorld, pos: torch.Tensor) -> torch.Tensor:
    """(…, A) flight-time cost from position(s) pos (…, 3) to every action."""
    return travel_costs(
        world.actions_xyz, pos[..., None, :], world.cfg.uav.max_v, world.cfg.uav.max_a
    )


def sweep_rewards(world: IPPWorld, state: BeliefState, jitter: float = 0.0):
    """Reward of EVERY lattice action for every mission: returns
    (rewards (B, A), costs (B, A)) — the all-action sweep
    (ops/kalman.kf_sweep_gains_batched) divided by cost + 1."""
    cfg = world.cfg
    mask = None
    if cfg.scenario.adaptive:
        diag = torch.diagonal(state.cov, dim1=-2, dim2=-1)
        mask = adaptive_mask(
            state.mean, diag, cfg.scenario.value_threshold, cfg.scenario.interval_factor
        )
    gains = kf_sweep_gains_batched(
        state.cov, world.sweep_batched, mask, jitter, fast_math=world.fast_sweeps
    )
    costs = action_costs_from(world, state.pos)
    return reward_from_gain(gains, costs), costs


def feasible_mask(budget: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    """(B, A) feasibility: 0 < cost ≤ budget (reference
    planning/common/actions.py:44-66)."""
    return (costs > 0) & (costs <= budget[:, None])


@dataclass
class MissionResult:
    """Rectangular per-step history of a mission batch (host numpy)."""

    waypoints: np.ndarray  # (B, T, 3) — NaN after mission end
    metrics: Dict[str, np.ndarray]  # each (B, T+1) — step 0 is the prior
    budgets: np.ndarray  # (B, T+1)
    num_steps: np.ndarray  # (B,)
    flight_times: np.ndarray  # (B, T) — 0 after mission end
    final_state: Optional[BeliefState] = None

    def metric_curve(self, name: str) -> np.ndarray:
        return self.metrics[name]


class Planner:
    """Base class: concrete planners implement ``plan`` (choose the next
    lattice action per mission) or override ``run`` entirely."""

    name = "base"

    def __init__(self, world: IPPWorld, mission_cfg: MissionConfig):
        self.world = world
        self.mission_cfg = mission_cfg
        self.cfg: Config = world.cfg

    def plan(
        self, state: BeliefState, generator: Optional[torch.Generator], step: int
    ) -> torch.Tensor:
        """Return (B,) lattice action indices for the next measurement."""
        raise NotImplementedError

    def max_steps(self) -> int:
        """Step bound: budget / cheapest feasible hop."""
        off_diag = ~np.eye(self.world.num_actions, dtype=bool)
        min_cost = float(np.min(self.world.table.pair_cost[off_diag]))
        return int(np.ceil(self.cfg.constraints.budget / max(min_cost, 1e-6))) + 1

    def run(
        self,
        batch_size: int,
        max_steps: Optional[int] = None,
        init_state: Optional[BeliefState] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> MissionResult:
        """Execute the batched mission loop and collect metric histories.

        Draws come from ``generator`` (on the world's device; None uses
        torch's default), except the measurement noise when ``noise``
        (T, B, M) is given."""
        world = self.world
        T = max_steps if max_steps is not None else self.max_steps()
        state = init_state if init_state is not None else world.init_state(batch_size, generator)
        B = state.batch_size
        budgets = [state.budget]
        metrics_h = [world.evaluate(state)]
        wps, actives, flight = [], [], []
        for t in range(T):
            action = self.plan(state, generator, t)
            cost = travel_costs(
                world.actions_xyz[action], state.pos, self.cfg.uav.max_v, self.cfg.uav.max_a
            )
            # a mission stays active while it can afford a positive-cost move
            # (reference planning/greedy_mission.py:79-96)
            can_move = state.active & (cost <= state.budget) & (cost > 0)
            state = state.replace(active=can_move)
            state = world.step_index(
                state, action, None if noise is None else noise[t], generator
            )
            metrics_h.append(world.evaluate(state))
            wps.append(torch.where(can_move[:, None], world.actions_xyz[action], float("nan")))
            budgets.append(state.budget)
            actives.append(can_move)
            flight.append(torch.where(can_move, cost, 0.0))

        def host(xs, empty_shape):
            if not xs:
                return np.zeros(empty_shape)
            return torch.stack(xs, dim=1).cpu().numpy()

        return MissionResult(
            waypoints=host(wps, (B, 0, 3)),
            metrics={k: host([m[k] for m in metrics_h], None) for k in metrics_h[0]},
            budgets=host(budgets, None),
            num_steps=host(actives, (B, 0)).sum(axis=1),
            flight_times=host(flight, (B, 0)),
            final_state=state,
        )
