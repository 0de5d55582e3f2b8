"""Planner base: the mission loop shared by every planner.

Port of ``ipp_rl_tpu/planners/base.py``.  The JAX package's ``lax.scan``
over a static step bound becomes a Python loop with per-mission active
masks: missions that exhaust their budget keep carrying state but stop
measuring (mask-and-continue), so metric histories stay rectangular
(B, T+1).  Once no mission can move, every later step is a no-op, and
the loop leaves early where the skipped steps would draw nothing: the
history is then padded on the host as those steps would have filled it.
Histories stay on the device and move to the host once, at the end of
the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config, MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import euclidean_distances, travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_sweep_gains_batched
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask, reward_from_gain
from ipp_rl_tpu_torch.utils.tracing import count, span

#: steps between a step's "any mission still active" flag and its read on
#: the host: the read waits on a step long done while the next is queued
FLAG_LAG = 2


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
    with span("plan.sweep"):
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


def feasible_mask(
    budget: torch.Tensor,
    costs: torch.Tensor,
    world: Optional[IPPWorld] = None,
    pos: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
) -> torch.Tensor:
    """(B, A) feasibility: 0 < cost ≤ budget, and with ``max_distance``
    (which needs the world and the positions pos (B, 3)) closer than it
    (reference planning/common/actions.py:44-66,
    planning/mcts_zero/mcts.py:148-158)."""
    ok = (costs > 0) & (costs <= budget[:, None])
    if max_distance is not None:
        dist = euclidean_distances(world.actions_xyz[None, :, :], pos[:, None, :])
        ok = ok & (dist < max_distance)
    return ok


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
    #: whether ``plan`` draws from the generator when no ``draws`` are given
    plan_draws = True

    def __init__(self, world: IPPWorld, mission_cfg: MissionConfig):
        self.world = world
        self.mission_cfg = mission_cfg
        self.cfg: Config = world.cfg

    def plan(
        self, state: BeliefState, generator: Optional[torch.Generator], step: int,
        draws: Any = None,
    ) -> torch.Tensor:
        """Return (B,) lattice action indices for the next measurement;
        a random planner takes its draws from ``draws`` when given."""
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
        think_time_per_step: float = 0.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draws: Optional[Sequence[Any]] = None,
    ) -> MissionResult:
        """Execute the batched mission loop and collect metric histories.

        ``think_time_per_step`` is charged against the budget of every
        moving mission when the config counts effective mission time
        (reference planning/greedy_mission.py:105-106).  Draws come from
        ``generator`` (on the world's device; None uses torch's default),
        except the measurement noise when ``noise`` (T, B, M) is given and
        the planner's own when ``draws`` (one entry per step) are.

        Once no mission is active every later step is a no-op.  Where those
        steps would draw nothing (``noise`` given, and ``draws`` given or a
        ``plan`` that draws nothing), the loop leaves when a step's flag,
        read :data:`FLAG_LAG` steps later, shows no mission active, and the
        history is padded to T steps: the result and the generator's state
        are those of the whole loop."""
        world = self.world
        T = max_steps if max_steps is not None else self.max_steps()
        think = think_time_per_step if self.cfg.evaluation.use_effective_mission_time else 0.0
        may_exit = noise is not None and (draws is not None or not self.plan_draws)
        with span("plan.run"):
            state = (init_state if init_state is not None
                     else world.init_state(batch_size, generator))
            history = MissionHistory(world, state)
            flags = ActiveFlags(T, state.active.device) if may_exit and T > FLAG_LAG else None
            for t in range(T):
                if flags is not None and t >= FLAG_LAG and not flags.read(t - FLAG_LAG):
                    break
                action = self.plan(state, generator, t, None if draws is None else draws[t])
                cost = travel_costs(
                    world.actions_xyz[action], state.pos, self.cfg.uav.max_v, self.cfg.uav.max_a
                )
                # a mission stays active while it can afford a positive-cost move
                # (reference planning/greedy_mission.py:79-96)
                can_move = state.active & (cost <= state.budget) & (cost > 0)
                state = state.replace(active=can_move)
                if flags is not None:
                    flags.record(t, can_move)
                state = world.step_index(
                    state, action, None if noise is None else noise[t], generator
                )
                state = charge_think_time(state, can_move, think)
                history.add(state, world.actions_xyz[action], can_move, cost)
            ran = len(history.actives)
            count("plan.steps", ran)
            count("plan.steps_skipped", T - ran)
            return history.result(state, steps=T)


class ActiveFlags:
    """Per step, whether any mission is still active, copied to the host
    without a wait (pinned memory and a CUDA event on the card) and read
    later; each read counts as one of ``host_syncs``."""

    def __init__(self, steps: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros(steps, dtype=torch.bool, pin_memory=self.cuda)
        self.events: List[Optional[torch.cuda.Event]] = [None] * steps

    def record(self, t: int, active: torch.Tensor) -> None:
        self.flags[t].copy_(active.any(), non_blocking=self.cuda)
        if self.cuda:
            self.events[t] = torch.cuda.Event()
            self.events[t].record()

    def read(self, t: int) -> bool:
        if self.events[t] is not None:
            self.events[t].synchronize()
        count("host_syncs")
        return bool(self.flags[t])


def charge_think_time(state: BeliefState, moved: torch.Tensor, think: float) -> BeliefState:
    """The planning time of a replan charged against the budget of the
    missions that moved ("effective mission time")."""
    if not think:
        return state
    return state.replace(budget=torch.where(moved, state.budget - think, state.budget))


class MissionHistory:
    """The per-step record of a mission loop, on the device until
    :meth:`result` moves it to the host once."""

    def __init__(self, world: IPPWorld, state: BeliefState):
        self.world = world
        self.B = state.batch_size
        self.budgets = [state.budget]
        with span("plan.evaluate"):
            self.metrics = [world.evaluate(state)]
        self.wps, self.actives, self.flight = [], [], []

    def add(self, state: BeliefState, waypoint: torch.Tensor, moved: torch.Tensor,
            cost: torch.Tensor) -> None:
        """One step: the state after it, the waypoints (B, 3) taken by the
        missions that ``moved`` and their flight costs."""
        with span("plan.evaluate"):
            self.metrics.append(self.world.evaluate(state))
        self.wps.append(torch.where(moved[:, None], waypoint, float("nan")))
        self.budgets.append(state.budget)
        self.actives.append(moved)
        self.flight.append(torch.where(moved, cost, 0.0))

    def result(self, final_state: BeliefState, steps: Optional[int] = None) -> MissionResult:
        """The histories on the host; with ``steps`` past the steps recorded,
        padded to ``steps`` as steps in which no mission moves fill them:
        NaN waypoints, zero flight times, and budgets and metrics that
        repeat their last column (``final_state`` is then the state after
        ``steps`` steps as well)."""

        def host(xs, empty_shape):
            if not xs:
                return np.zeros(empty_shape)
            count("host_syncs")
            return torch.stack(xs, dim=1).cpu().numpy()

        def pad(a, fill=None):
            if not skipped:
                return a
            width = [(0, 0)] * a.ndim
            width[1] = (0, skipped)
            if fill is None:
                return np.pad(a, width, mode="edge")
            return np.pad(a, width, constant_values=fill)

        B = self.B
        skipped = 0 if steps is None else steps - len(self.actives)
        with span("plan.history"):
            return MissionResult(
                waypoints=pad(host(self.wps, (B, 0, 3)), np.nan),
                metrics={k: pad(host([m[k] for m in self.metrics], None))
                         for k in self.metrics[0]},
                budgets=pad(host(self.budgets, None)),
                num_steps=host(self.actives, (B, 0)).sum(axis=1),
                flight_times=pad(host(self.flight, (B, 0)), 0),
                final_state=final_state,
            )
