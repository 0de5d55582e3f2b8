"""Greedy planner: per step, price every feasible action with a one-step
Kalman lookahead and take the argmax (reference
planning/greedy_mission.py:73-110, planning/common/optimization.py:33-104).

Port of ``ipp_rl_tpu/planners/greedy.py``: the reference's process-pool
sweep over the actions is one batched sweep (planners/base.sweep_rewards);
a multi-step horizon is a loop of hypothetical covariance-only commits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ipp_rl_tpu_torch.env.world import BeliefState
from ipp_rl_tpu_torch.ops.kalman import kf_update
from ipp_rl_tpu_torch.planners.base import Planner, feasible_mask, sweep_rewards


class GreedyPlanner(Planner):
    name = "greedy"

    def plan(
        self, state: BeliefState, generator: Optional[torch.Generator], step: int,
        draws=None,
    ) -> torch.Tensor:
        rewards, costs = sweep_rewards(self.world, state)
        ok = feasible_mask(state.budget, costs)
        scored = torch.where(ok, rewards, float("-inf"))
        # ties go to the first maximum, as jnp.argmax
        return torch.argmax(scored, dim=-1)


def greedy_search_horizon(world, state: BeliefState, horizon: int):
    """Multi-step greedy rollout (reference planning/common/optimization.py:33-104):
    repeatedly price all actions against the *hypothetical* covariance,
    commit the argmax covariance-only, decrement the budget.  A mission
    with no feasible action keeps its state.

    Returns (waypoint indices (B, horizon), valid (B, horizon))."""
    cov, pos, budget = state.cov, state.pos, state.budget
    actions, valids = [], []
    for _ in range(horizon):
        rewards, costs = sweep_rewards(world, state.replace(cov=cov, pos=pos, budget=budget))
        ok = feasible_mask(budget, costs)
        a = torch.argmax(torch.where(ok, rewards, float("-inf")), dim=-1)
        any_ok = torch.any(ok, dim=-1)
        cost_a = torch.gather(costs, -1, a[:, None])[:, 0]
        _, cov_next = kf_update(cov, state.mean, world.H[a], world.R_diag[a], z=None)
        cov = torch.where(any_ok[:, None, None], cov_next, cov)
        pos = torch.where(any_ok[:, None], world.actions_xyz[a], pos)
        budget = torch.where(any_ok, budget - cost_a, budget)
        actions.append(a)
        valids.append(any_ok)
    return torch.stack(actions, dim=1), torch.stack(valids, dim=1)
