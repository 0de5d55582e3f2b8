"""CMA-ES trajectory-refinement planner (reference planning/ipp_masha.py).

Port of ``ipp_rl_tpu/planners/cmaes.py``.  A replan initialises a horizon
of waypoints greedily (``greedy_search_horizon``, the all-action sweep),
refines the flattened 3H-dim waypoint vector by CMA-ES (reference
:160-219) on the objective −Σ reward·(cost+1) / path_cost with an
out-of-bounds penalty of 100 (reference :102-140), keeps the greedy plan
when CMA-ES does not beat it (:214-215), and executes the first waypoint.

Every mission's CMA-ES runs at once: the state is batched over missions
(covariances (B, D, D)) and one fitness call simulates all B·λ members'
trajectories, one waypoint at a time, through the per-sample edge update
(``ops/kalman.kf_edge_factor_gain_per_sample``, one launch of the
``edge_factor_gain`` kernel per waypoint).  The eigendecomposition and the
normal draws can be injected, so that a test reproduces the JAX
package's samples: the two ``eigh`` agree only up to the signs of the
eigenvector columns, and the samples depend on those signs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import out_of_bounds, travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_edge_factor_gain_per_sample
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.ops.smallchol import _sqrt
from ipp_rl_tpu_torch.planners.base import (
    MissionHistory,
    MissionResult,
    Planner,
    charge_think_time,
)
from ipp_rl_tpu_torch.planners.greedy import greedy_search_horizon
from ipp_rl_tpu_torch.utils.tracing import span

#: penalty of a trajectory that leaves the box or has no length
PENALTY = 100.0


class CMAState(NamedTuple):
    mean: torch.Tensor  # (B, D)
    sigma: torch.Tensor  # (B,)
    C: torch.Tensor  # (B, D, D)
    p_sigma: torch.Tensor  # (B, D)
    p_c: torch.Tensor  # (B, D)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return _sqrt(torch.sum(x * x, dim=-1))


def cma_es_minimize(
    objective: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    sigma_scales: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    popsize: int,
    maxiter: int,
    normals: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eigh: Callable = torch.linalg.eigh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimal CMA-ES with CSA step-size control and rank-1 + rank-μ
    covariance adaptation, for B problems at once: ``objective`` maps a
    population (B, λ, D) to its losses (B, λ); x0 (B, D); the scales,
    bounds (D,).  Returns (best_x (B, D), best_loss (B,)).

    Each generation draws its normals (B, λ, D) from ``generator``, or
    takes ``normals[:, g]`` of the given (B, maxiter, λ, D).  ``eigh`` is
    the eigendecomposition of the (B, D, D) covariances (values ascending,
    vectors as columns).  The selection sorts stably: members on the
    penalty share one loss, and the first of them is kept, as
    ``jnp.argsort`` keeps it."""
    B, D = x0.shape
    dt, dev = x0.dtype, x0.device
    lam = popsize
    mu = lam // 2
    # strategy constants in float64 on the host, as the JAX package's
    w_np = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w_np = w_np / w_np.sum()
    w = torch.as_tensor(w_np, dtype=dt, device=dev)
    mu_eff = float(1.0 / np.sum(w_np**2))
    c_sigma = (mu_eff + 2.0) / (D + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (D + 1.0)) - 1.0) + c_sigma
    c_c = (4.0 + mu_eff / D) / (D + 4.0 + 2.0 * mu_eff / D)
    c_1 = 2.0 / ((D + 1.3) ** 2 + mu_eff)
    c_mu = min(1.0 - c_1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((D + 2.0) ** 2 + mu_eff))
    chi_n = float(np.sqrt(D) * (1.0 - 1.0 / (4.0 * D) + 1.0 / (21.0 * D * D)))
    path_sigma = float(np.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff))
    path_c = float(np.sqrt(c_c * (2.0 - c_c) * mu_eff))
    h_norm = float(np.sqrt(1.0 - (1.0 - c_sigma) ** 2))
    h_limit = (1.4 + 2.0 / (D + 1.0)) * chi_n

    st = CMAState(
        mean=x0,
        sigma=torch.ones((B,), dtype=dt, device=dev),
        C=torch.diag_embed(sigma_scales**2).expand(B, D, D),
        p_sigma=torch.zeros_like(x0),
        p_c=torch.zeros_like(x0),
    )
    best_x, best_f = x0, torch.full((B,), float("inf"), dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    for g in range(maxiter):
        with span("cmaes.eigh"):
            evals, Bm = eigh(st.C)
        evals = torch.clamp(evals, min=1e-20)
        Dm = Bm * _sqrt(evals)[:, None, :]  # C^{1/2}
        if normals is None:
            z = torch.randn((B, lam, D), generator=generator, dtype=dt, device=dev)
        else:
            z = normals[:, g].to(dt)
        y = z @ Dm.mT  # (B, λ, D) ~ N(0, C)
        x = st.mean[:, None, :] + st.sigma[:, None, None] * y
        x = torch.clamp(x, lower, upper)
        f = objective(x)  # (B, λ)

        order = torch.argsort(f, dim=-1, stable=True)
        x_sel = torch.gather(x, 1, order[:, :mu, None].expand(B, mu, D))
        y_sel = (x_sel - st.mean[:, None, :]) / st.sigma[:, None, None]

        mean_new = st.mean + torch.sum(w[None, :, None] * (x_sel - st.mean[:, None, :]), dim=1)
        y_w = torch.sum(w[None, :, None] * y_sel, dim=1)

        C_inv_sqrt = (Bm * (1.0 / _sqrt(evals))[:, None, :]) @ Bm.mT
        p_sigma = (1.0 - c_sigma) * st.p_sigma + path_sigma * (C_inv_sqrt @ y_w[..., None])[..., 0]
        sigma_new = st.sigma * torch.exp((c_sigma / d_sigma) * (_norm(p_sigma) / chi_n - 1.0))
        h_sigma = (_norm(p_sigma) / h_norm < h_limit).to(dt)
        p_c = (1.0 - c_c) * st.p_c + (h_sigma * path_c)[:, None] * y_w
        rank1 = p_c[:, :, None] * p_c[:, None, :]
        # Σ_i w_i·y_ij·y_ik as the JAX package's einsum contracts it: the
        # weighted rows first, then one product over i
        rank_mu = (w[None, :, None] * y_sel).mT @ y_sel
        C_new = (
            (1.0 - c_1 - c_mu) * st.C
            + c_1 * (rank1 + ((1.0 - h_sigma) * c_c * (2.0 - c_c))[:, None, None] * st.C)
            + c_mu * rank_mu
        )
        C_new = 0.5 * (C_new + C_new.mT)

        first = order[:, 0]
        gen_best = f[rows, first]
        better = gen_best < best_f
        best_x = torch.where(better[:, None], x[rows, first], best_x)
        best_f = torch.where(better, gen_best, best_f)
        st = CMAState(mean_new, sigma_new, C_new, p_sigma, p_c)
    return best_x, best_f


class CMAESPlanner(Planner):
    """Greedy-init + CMA-ES refined replanning (reference IPPMashaMission).
    ``self.eigh`` is the eigendecomposition CMA-ES uses (torch's; a test
    replaces the attribute to replay another's)."""

    name = "cmaes"

    def __init__(self, world: IPPWorld, mission_cfg: MissionConfig):
        super().__init__(world, mission_cfg)
        self.horizon = max(mission_cfg.episode_horizon, 1)
        self.popsize = mission_cfg.cma_popsize
        self.maxiter = mission_cfg.cma_maxiter
        self.eigh = torch.linalg.eigh
        # per-coordinate sigma scales (reference :142-158): xy = sigma0,
        # z capped at half the altitude band
        con = self.cfg.constraints
        s = mission_cfg.cma_sigma
        sz = min(s, (con.max_altitude - con.min_altitude) / 2.0)
        self.sigma_scales = np.tile([s, s, sz], self.horizon).astype(np.float32)

    def trajectory_loss(
        self,
        flat_wps: torch.Tensor,  # (B, K, D) = (B, K, H·3)
        cov: torch.Tensor,  # (B, N, N)
        mean: torch.Tensor,  # (B, N)
        pos: torch.Tensor,  # (B, 3)
        budget: torch.Tensor,  # (B,)
    ) -> torch.Tensor:
        """(B, K) losses −Σ reward·(cost+1) / path_cost of K candidate
        trajectories per mission, 100 out of bounds or for a zero path
        (reference ipp_masha.py:102-140): each waypoint prices the
        mission's hypothetical belief with the edge update, and the
        trajectory's belief takes the measurement while its budget lasts."""
        with span("cmaes.fitness"):
            cfg, world = self.cfg, self.world
            B, K, D = flat_wps.shape
            H = self.horizon
            wps = flat_wps.reshape(B * K, H, 3)
            oob = torch.any(out_of_bounds(wps, cfg), dim=-1)

            def per_member(x):
                return x.repeat_interleave(K, dim=0)

            prevs = torch.cat([per_member(pos)[:, None, :], wps[:, :-1]], dim=1)
            seg_costs = travel_costs(wps, prevs, cfg.uav.max_v, cfg.uav.max_a)  # (BK, H)
            path_cost = torch.sum(seg_costs, dim=-1)

            dm = None
            if cfg.scenario.adaptive:
                dm = per_member(adaptive_mask(
                    mean, torch.diagonal(cov, dim1=-2, dim2=-1),
                    cfg.scenario.value_threshold, cfg.scenario.interval_factor).to(cov.dtype))

            P = per_member(cov)
            rem = per_member(budget)
            total = torch.zeros_like(rem)
            alive = torch.ones_like(rem, dtype=torch.bool)
            for h in range(H):
                cost = seg_costs[:, h]
                alive = alive & (cost <= rem)
                Hm, R, _, _ = world.measurement_model_at(wps[:, h].contiguous())
                WcT, gain = kf_edge_factor_gain_per_sample(P, Hm, R, dm)
                reward = gain / (cost + 1.0)
                total = total + torch.where(alive, reward * (cost + 1.0), 0.0)
                if h + 1 < H:  # the last waypoint's belief is never read
                    P = torch.where(alive[:, None, None],
                                    torch.baddbmm(P, WcT.mT, WcT, alpha=-1), P)
                rem = torch.where(alive, rem - cost, rem)
            loss = -total / torch.clamp(path_cost, min=1e-12)
            bad = oob | (path_cost <= 0)
            return torch.where(bad, PENALTY, loss).view(B, K)

    def replan_batch(
        self,
        state: BeliefState,
        normals: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, 3) refined waypoint plans and (B,) validity (the greedy
        horizon found a feasible first action).  ``normals`` (B, maxiter,
        λ, D): CMA-ES's draws, else drawn from ``generator``."""
        world, cfg = self.world, self.cfg
        H, B = self.horizon, state.batch_size
        dt, dev = world.dtype, world.device
        with span("cmaes.replan"):
            actions, valids = greedy_search_horizon(world, state, H)
            x0 = world.actions_xyz[actions].reshape(B, 3 * H)
            lower = torch.tensor([0.0, 0.0, cfg.constraints.min_altitude], dtype=dt,
                                 device=dev).repeat(H)
            upper = torch.tensor([cfg.environment.extent_x, cfg.environment.extent_y,
                                  cfg.constraints.max_altitude], dtype=dt, device=dev).repeat(H)
            scales = torch.as_tensor(self.sigma_scales, device=dev).to(dt)

            def objective(x):
                return self.trajectory_loss(x, state.cov, state.mean, state.pos, state.budget)

            with span("cmaes.minimize"):
                best_x, best_f = cma_es_minimize(objective, x0, scales, lower, upper,
                                                 self.popsize, self.maxiter, normals, generator,
                                                 self.eigh)
            greedy_f = objective(x0[:, None, :])[:, 0]
            # keep greedy unless CMA-ES beats it (reference :214-215)
            wps = torch.where((best_f < greedy_f)[:, None], best_x, x0)
            return wps.reshape(B, H, 3), valids[:, 0]

    def run(
        self,
        batch_size: int,
        max_steps: Optional[int] = None,
        init_state: Optional[BeliefState] = None,
        think_time_per_step: float = 0.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draws: Optional[Sequence[torch.Tensor]] = None,
    ) -> MissionResult:
        """Adaptive replanning loop: refine a horizon, fly its first
        waypoint, repeat, for ``max_steps`` steps (reference :221-251,
        adaptive branch).  Draws come from ``generator``, except the
        measurement noise when ``noise`` (T, B, m_max_cont) is given and
        CMA-ES's normals when ``draws`` (one (B, maxiter, λ, D) per step)
        are."""
        world, cfg = self.world, self.cfg
        think = think_time_per_step if cfg.evaluation.use_effective_mission_time else 0.0
        T = max_steps if max_steps is not None else self.max_steps()
        with span("plan.run"):
            state = (init_state if init_state is not None
                     else world.init_state(batch_size, generator))
            history = MissionHistory(world, state)
            for t in range(T):
                wps, any_valid = self.replan_batch(state, None if draws is None else draws[t],
                                                   generator)
                wp = wps[:, 0, :]
                cost = travel_costs(wp, state.pos, cfg.uav.max_v, cfg.uav.max_a)
                can_move = state.active & any_valid & (cost <= state.budget) & (cost > 0)
                state = state.replace(active=can_move)
                state = world.step_position(state, wp, None if noise is None else noise[t],
                                            generator)
                state = charge_think_time(state, can_move, think)
                history.add(state, wp, can_move, cost)
            return history.result(state)
