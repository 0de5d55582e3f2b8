"""Plain reference of the greedy mission, and the comparison that
judges a greedy run.

``greedy_loop`` follows a batch of missions step by step.  Given the
program's waypoints it replays them (teacher forcing): at each step it
prices every lattice action against its own belief, measures where the
program's waypoint says the greedy choice lies among them, checks that
the move was affordable and that no mission stopped while it could still
move, and commits the program's measurement with the same noise.  Given
none, it plans itself (the lower-precision control takes the program's
place so).

The numbers a run is judged by:

* ``reward_gap``: the widest gap, over every move, between the best
  affordable action's reward and the reward of the action taken, as a
  share of the best: greedy takes the best, so a sound run reads only
  the rounding of its own sweep;
* ``belief_err``: the widest gap between the program's map metrics at
  every step (masked tr(P), RMSE) and the reference's, as a share of the
  prior's, and between the final means and covariances;
* ``violations``: moves the budget could not pay for, missions that
  stopped while an affordable move was left, and moves after a stop.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.world import RefWorld

#: seconds of budget within which float32 and float64 may disagree on
#: whether a move is affordable
BUDGET_TOL = 1e-3
#: floor of the best reward in the gap's denominator
REWARD_FLOOR = 1e-6


def greedy_loop(world: RefWorld, init: Dict[str, torch.Tensor], noise: torch.Tensor,
                steps: int, waypoints: Optional[torch.Tensor] = None,
                stop_below: float = 0.0) -> Dict[str, torch.Tensor]:
    """Run or replay ``steps`` greedy steps of S missions.

    init: mean (S, N), cov (S, N, N), pos (S, 3), budget (S,), gt (S, N);
    noise (S, steps, M); waypoints (S, steps, 3), NaN where the program did
    not move.  ``stop_below``: a mission also stops once its budget is under
    it (the closed loop stops under one cell's resolution).  Returns the
    reference's metric histories (S, steps + 1), final mean and cov, the
    waypoints flown, and with ``waypoints`` the readings above."""
    dt = world.arith.dtype
    dev = world.device
    mean = init["mean"].to(dev, dt)
    P = init["cov"].to(dev, dt)
    pos = init["pos"].to(dev, torch.float64)
    budget = init["budget"].to(dev, torch.float64)
    gt = init["gt"].to(dev, dt)
    S = mean.shape[0]
    noise = noise.to(dev, dt)
    H, R, Z, std = world.H, world.R, world.Z, world.noise_std
    A = world.num_actions
    active = torch.ones(S, dtype=torch.bool, device=dev)
    hist = {k: [v] for k, v in world.metrics(gt, mean, P).items()}
    flown = torch.full((S, steps, 3), float("nan"), dtype=torch.float64, device=dev)
    gap = torch.zeros((), dtype=torch.float64, device=dev)
    violations = torch.zeros((), dtype=torch.int64, device=dev)
    moves = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.arange(S, device=dev)
    for t in range(steps):
        costs = world.flight_time(world.xyz[None], pos[:, None])  # (S, A)
        affordable = (costs > 0) & (costs <= budget[:, None])
        rewards = world.gains(P, world.roi(mean, P), H[None].expand(S, -1, -1, -1),
                              R[None].expand(S, -1, -1)).to(torch.float64) / (costs + 1.0)
        scored = torch.where(affordable, rewards, float("-inf"))
        best, best_a = torch.max(scored, dim=-1)
        can = active & (budget >= stop_below)
        if waypoints is None:
            moved = can & affordable.any(dim=-1)
            a = best_a
        else:
            wp = waypoints[:, t].to(dev, torch.float64)
            moved = ~torch.isnan(wp[:, 0])
            a = world.action_index(torch.nan_to_num(wp))
            cost_a = costs[rows, a]
            paid = (cost_a > 0) & (cost_a <= budget + BUDGET_TOL)
            surely = affordable & (costs <= budget[:, None] - BUDGET_TOL)
            stopped = (~moved & can & surely.any(dim=-1)) | (moved & ~can)
            violations = violations + torch.sum(moved & ~paid) + torch.sum(stopped)
            chosen = rewards[rows, a]
            g = (best - chosen) / torch.clamp(best, min=REWARD_FLOOR)
            ok = moved & torch.isfinite(best)
            gap = torch.maximum(gap, torch.max(torch.where(ok, g, 0.0)))
            moves = moves + torch.sum(moved)
        cost = world.flight_time(world.xyz[a], pos)
        eps = noise[:, t]
        z = world.reading(gt, Z[a], std[a], eps)
        mean_n, P_n = world.commit(P, mean, H[a], R[a], z)
        mean = torch.where(moved[:, None], mean_n, mean)
        P = torch.where(moved[:, None, None], P_n, P)
        flown[:, t] = torch.where(moved[:, None], world.xyz[a], float("nan"))
        pos = torch.where(moved[:, None], world.xyz[a], pos)
        budget = torch.where(moved, budget - cost, budget)
        active = active & moved
        for k, v in world.metrics(gt, mean, P).items():
            hist[k].append(v)
    out = {k: torch.stack(v, dim=1) for k, v in hist.items()}
    out.update(mean=mean, cov=P, waypoints=flown)
    if waypoints is not None:
        out.update(reward_gap=gap, violations=violations, moves=moves)
    return out


def belief_err(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The widest gap between the program's beliefs and the reference's:
    metric histories (S, T + 1) as a share of the prior's, final means in
    the field's units, final covariances as a share of the prior's
    largest entry.  Keys of ``got`` that are absent are not compared."""
    errs = []
    for k in ("uncertainty", "rmse"):
        if k in got:
            r = ref[k].to(torch.float64)
            scale = torch.clamp(r[:, :1].abs(), min=1e-6)
            errs.append(torch.max(torch.abs(got[k].to(r) - r) / scale))
    if "mean" in got:
        errs.append(torch.max(torch.abs(got["mean"].to(torch.float64) - ref["mean"].to(torch.float64))))
    if "cov" in got:
        scale = torch.clamp(ref["cov0"].abs().amax(dim=(-2, -1), keepdim=True), min=1e-12)
        d = torch.abs(got["cov"].to(torch.float64) - ref["cov"].to(torch.float64)) / scale
        errs.append(torch.max(d))
    return torch.max(torch.stack(errs))
