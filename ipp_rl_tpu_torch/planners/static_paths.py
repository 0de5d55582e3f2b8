"""Static and random baseline planners (reference planning/baselines/).

Port of ``ipp_rl_tpu/planners/static_paths.py``.  Waypoint patterns are
config-static host numpy (lawnmower, spiral) or uniform draws; execution
is the batched measure-and-commit loop over *continuous* waypoints
(``IPPWorld.step_position``, the measurement model built per position).
The random discrete baseline picks lattice actions through the base
planner's loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.env.world import BeliefState
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.planners.base import (
    MissionHistory,
    MissionResult,
    Planner,
    action_costs_from,
    charge_think_time,
    feasible_mask,
)
from ipp_rl_tpu_torch.planners.zero.selfplay import gumbel


def lawnmower_waypoints(cfg: Config, step_size: float) -> np.ndarray:
    """Boustrophedon sweep per altitude level, budget-truncated at execution
    time (reference planning/baselines/lawn_mower_mission.py:66-114).

    The reference builds int-cast [sweep, cross, alt] triples; this emits
    (x, y, z) with the serpentine on x."""
    con, env = cfg.constraints, cfg.environment
    lo = con.dist_to_boundaries
    hi_x = env.extent_x - con.dist_to_boundaries
    hi_y = env.extent_y - con.dist_to_boundaries
    xs = np.linspace(lo, hi_x, int((hi_x - lo) / step_size) + 1)
    ys = np.linspace(lo, hi_y, int((hi_y - lo) / step_size) + 1)
    levels = np.linspace(con.min_altitude, con.max_altitude, con.altitude_levels)
    wps = []
    for z in levels:
        for j, y in enumerate(ys):
            row_xs = xs if j % 2 == 0 else env.extent_x - xs
            for x in row_xs:
                wps.append((float(int(x)), float(int(y)), float(int(z))))
    return np.asarray(wps)


def spiral_waypoints(cfg: Config, num_waypoints: int, slope_factor: float = 1.0) -> np.ndarray:
    """3-D conical spiral, radius growing with t, altitude descending
    (reference planning/baselines/conical_spiral_mission.py:67-108)."""
    con, env = cfg.constraints, cfg.environment
    t_max = 0.5 * min(env.extent_x, env.extent_y) - con.dist_to_boundaries
    c = (con.max_altitude - con.min_altitude) / t_max**2
    t = np.linspace(0.0, t_max, num_waypoints)
    x = t * np.cos(slope_factor * t) + 0.5 * env.extent_x
    y = t * np.sin(slope_factor * t) + 0.5 * env.extent_y
    z = np.flip(c * np.square(t) + con.min_altitude)
    return np.stack([x, y, z], axis=1)


class WaypointListPlanner(Planner):
    """Executes a fixed (possibly per-mission) waypoint list with budget
    truncation: stop before the first unaffordable hop (reference
    lawn_mower_mission.py:126-140)."""

    name = "waypoint_list"

    def waypoint_list(
        self, batch_size: int, generator: Optional[torch.Generator], draws=None
    ) -> torch.Tensor:
        """(B, T, 3) waypoints per mission on the world's device."""
        raise NotImplementedError

    def _broadcast(self, wps: np.ndarray, batch_size: int) -> torch.Tensor:
        w = self.world
        return torch.as_tensor(wps, dtype=w.dtype, device=w.device).expand(
            (batch_size,) + wps.shape)

    def run(
        self,
        batch_size: int,
        max_steps: Optional[int] = None,
        init_state: Optional[BeliefState] = None,
        think_time_per_step: float = 0.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draws=None,
    ) -> MissionResult:
        """The waypoint list, cut at ``max_steps``, flown while each hop is
        affordable.  Draws come from ``generator`` (the initial state, the
        waypoints of a random list, the measurement noise), except the noise
        when ``noise`` (T, B, m_max_cont) is given and the list's draws when
        ``draws`` are."""
        world, cfg = self.world, self.cfg
        # effective mission time: the measured planning latency charged to
        # the budget (reference greedy_mission.py:105-106; near zero for
        # static paths but kept for a uniform surface)
        think = think_time_per_step if cfg.evaluation.use_effective_mission_time else 0.0
        state = init_state if init_state is not None else world.init_state(batch_size, generator)
        wps = self.waypoint_list(state.batch_size, generator, draws)  # (B, T, 3)
        T = wps.shape[1] if max_steps is None else min(max_steps, wps.shape[1])
        history = MissionHistory(world, state)
        for t in range(T):
            wp = wps[:, t, :]
            cost = travel_costs(wp, state.pos, cfg.uav.max_v, cfg.uav.max_a)
            # strict affordability: stop when budget <= cost
            # (reference lawn_mower_mission.py:130-131)
            can_move = state.active & (state.budget > cost)
            state = state.replace(active=can_move)
            state = world.step_position(state, wp, None if noise is None else noise[t], generator)
            state = charge_think_time(state, can_move, think)
            history.add(state, wp, can_move, cost)
        return history.result(state)


class LawnmowerPlanner(WaypointListPlanner):
    name = "lawnmower"

    def waypoint_list(self, batch_size, generator=None, draws=None):
        return self._broadcast(lawnmower_waypoints(self.cfg, self.mission_cfg.step_size),
                               batch_size)


class SpiralPlanner(WaypointListPlanner):
    name = "spiral"

    def waypoint_list(self, batch_size, generator=None, draws=None):
        return self._broadcast(spiral_waypoints(self.cfg, self.mission_cfg.num_waypoints),
                               batch_size)


class RandomContinuousPlanner(WaypointListPlanner):
    """Uniform random waypoints in the boundary-inset box (reference
    planning/baselines/random_continuous_mission.py:60-101).  The
    reference's ≤100 rejection trials per step only matter near budget
    exhaustion; budget truncation at execution handles that here."""

    name = "random_continuous"

    def num_waypoints(self) -> int:
        """The list's length: budget / min hop, generously."""
        con = self.cfg.constraints
        return int(np.ceil(con.budget / max(con.dist_to_boundaries, 1.0))) + 4

    def waypoint_list(self, batch_size, generator=None, draws=None):
        """``draws``: the uniform draws (B, T, 3) on [0, 1), else drawn
        from ``generator``."""
        con, env = self.cfg.constraints, self.cfg.environment
        w = self.world
        lo = torch.tensor([con.dist_to_boundaries, con.dist_to_boundaries, con.min_altitude],
                          dtype=w.dtype, device=w.device)
        hi = torch.tensor([env.extent_x - con.dist_to_boundaries,
                           env.extent_y - con.dist_to_boundaries, con.max_altitude],
                          dtype=w.dtype, device=w.device)
        if draws is None:
            draws = torch.rand((batch_size, self.num_waypoints(), 3), generator=generator,
                               dtype=w.dtype, device=w.device)
        return lo + draws.to(w.dtype) * (hi - lo)


class RandomDiscretePlanner(Planner):
    """Uniform over feasible lattice actions (distance < 11.5, cost ≤ budget)
    (reference planning/baselines/random_discrete_mission.py:73-107)."""

    name = "random_discrete"
    MAX_DIST = 11.5

    def plan(self, state, generator=None, step=0, draws=None) -> torch.Tensor:
        """A categorical draw over the feasible actions as
        ``jax.random.categorical`` makes it: the argmax (first on ties) of
        logits plus Gumbel draws (B, A), given as ``draws`` or drawn from
        ``generator``."""
        w = self.world
        costs = action_costs_from(w, state.pos)
        ok = feasible_mask(state.budget, costs, w, state.pos, max_distance=self.MAX_DIST)
        logits = torch.where(ok, 0.0, float("-inf")).to(w.dtype)
        # missions with no feasible action get a dummy draw; the run loop
        # deactivates them through the affordability check
        safe = torch.where(torch.any(ok, dim=-1, keepdim=True), logits, 0.0)
        g = draws.to(w.dtype) if draws is not None else gumbel(
            safe.shape, generator, w.dtype, w.device)
        return torch.argmax(g + safe, dim=-1)
