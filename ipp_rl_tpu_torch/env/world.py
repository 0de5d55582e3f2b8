"""Batched IPP world: belief state + measurement/commit dynamics.

Port of ``ipp_rl_tpu/env/world.py``.  The unit of work is a mission
batch: ``BeliefState`` holds tensors with a leading batch axis B, and
``IPPWorld`` holds the config and the ActionTable constants on its
device, with ``step_index`` (lattice actions) as the transition.
Randomness comes from an explicit ``torch.Generator`` or is passed in
(``noise``), so a test can feed both packages the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.fields import generate_ground_truth
from ipp_rl_tpu_torch.ops import metrics as metrics_ops
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_update, prepare_batched_sweep
from ipp_rl_tpu_torch.ops.priors import init_belief
from ipp_rl_tpu_torch.ops.sensor_model import (
    ActionTable,
    build_action_table,
    build_sweep_plan,
)


@dataclasses.dataclass
class BeliefState:
    """Per-mission belief + bookkeeping; all fields have leading batch axis B."""

    mean: torch.Tensor  # (B, N) flattened belief mean
    cov: torch.Tensor  # (B, N, N) belief covariance
    pos: torch.Tensor  # (B, 3) current UAV position (world metres)
    budget: torch.Tensor  # (B,) remaining travel budget
    ground_truth: torch.Tensor  # (B, N) flattened true field
    active: torch.Tensor  # (B,) bool — mission still running
    step: torch.Tensor  # (B,) int32 — measurements taken

    @property
    def batch_size(self) -> int:
        return self.mean.shape[0]

    def replace(self, **changes) -> "BeliefState":
        return dataclasses.replace(self, **changes)


class IPPWorld:
    """Static world/sensor model shared by all planners: the config and the
    ActionTable constants on ``device`` (the card unless told otherwise)."""

    def __init__(
        self,
        cfg: Config,
        dtype: torch.dtype = torch.float32,
        fast_sweeps: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        # bf16-streamed planner sweeps (ops/kalman.kf_sweep_gains_batched);
        # belief commits stay full precision either way
        self.fast_sweeps = fast_sweeps
        self.table: ActionTable = build_action_table(cfg)
        t = self.table

        def dev(x, dt=dtype):
            return torch.as_tensor(x, dtype=dt, device=self.device)

        self.H = dev(t.H)  # (A, M, N)
        self.R_diag = dev(t.R_diag)  # (A, M)
        self.Z = dev(t.Z)  # (A, M, N)
        self.noise_std = dev(t.noise_std)  # (A,)
        self.actions_xyz = dev(t.lattice.xyz)  # (A, 3)
        self.num_actions = t.num_actions
        plan = build_sweep_plan(t, x_dim=cfg.environment.x_dim, y_dim=cfg.environment.y_dim)
        self.sweep_batched = prepare_batched_sweep(plan, dtype, self.device)
        # initial UAV position: corner cell centre at max altitude
        # (reference planning/missions.py:69)
        res = cfg.environment.resolution
        self.init_pos = dev([0.5 * res, 0.5 * res, cfg.constraints.max_altitude])

    # ------------------------------------------------------------------ init

    def init_state(
        self,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        shuffle_prior: bool = False,
        ground_truth: Optional[torch.Tensor] = None,
        budget: Optional[torch.Tensor] = None,
    ) -> BeliefState:
        """Fresh mission batch: new worlds, GP priors, full budget.  Draws
        (worlds, shuffled priors) come from ``generator`` (a generator on
        this world's device; None uses torch's default one)."""
        cfg = self.cfg
        n = cfg.environment.num_cells
        B = batch_size
        if ground_truth is None:
            gt = generate_ground_truth(cfg, B, generator, self.device)
            gt = gt.reshape(B, n).to(self.dtype)
        else:
            gt = torch.as_tensor(ground_truth, device=self.device)
            gt = gt.to(self.dtype).expand(B, n).clone()

        unit_draws = normal = None
        if shuffle_prior:
            unit_draws = torch.rand(
                (B, 2) if cfg.mapping.fit_gaussian_process else (B,),
                generator=generator, device=self.device, dtype=self.dtype,
            )
        if not cfg.mapping.fit_gaussian_process:
            normal = torch.randn(
                (B, n, n), generator=generator, device=self.device, dtype=self.dtype
            )
        mean, cov = init_belief(
            cfg, shuffle_prior, unit_draws, normal, self.device, self.dtype
        )
        mean = mean.expand(B, n).clone()
        cov = cov.expand(B, n, n).clone()
        if budget is None:
            budget = torch.full(
                (B,), cfg.constraints.budget, dtype=self.dtype, device=self.device
            )
        return BeliefState(
            mean=mean,
            cov=cov,
            pos=self.init_pos.expand(B, 3).clone(),
            budget=budget,
            ground_truth=gt,
            active=torch.ones((B,), dtype=torch.bool, device=self.device),
            step=torch.zeros((B,), dtype=torch.int32, device=self.device),
        )

    # ------------------------------------------------------------ transitions

    def synthesize_measurement(
        self,
        ground_truth: torch.Tensor,
        Zmat: torch.Tensor,
        noise_std: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """z = clip(Z·gt + σ(h)·ε, 0, 1) — the simulated camera (reference
        simulations/simulations.py:26-34).  ground_truth (B, N), Zmat
        (B, M, N), noise_std (B,), ε (B, M) given as ``noise`` or drawn
        from ``generator``."""
        clean = (Zmat @ ground_truth[..., None])[..., 0]
        if noise is None:
            noise = torch.randn(
                clean.shape, generator=generator, device=clean.device, dtype=clean.dtype
            )
        return torch.clamp(clean + noise_std[:, None] * noise, 0.0, 1.0)

    def step_index(
        self,
        state: BeliefState,
        action_idx: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        jitter: float = 0.0,
    ) -> BeliefState:
        """Take a measurement at lattice action ``action_idx`` (B,) and
        commit the belief update; a no-op for inactive missions."""
        act = state.active
        # Inactive missions get zero measurement rows instead of a select
        # over the full covariance afterwards: H = 0 makes Kᵀ = 0, so the
        # Joseph commit returns P and the mean EXACTLY (P is kept
        # symmetric every commit, so the re-symmetrization is bit-neutral).
        H = self.H[action_idx] * act[:, None, None].to(self.dtype)  # (B, M, N)
        R = self.R_diag[action_idx]
        Zmat = self.Z[action_idx]
        std = self.noise_std[action_idx]
        z = self.synthesize_measurement(state.ground_truth, Zmat, std, noise, generator)
        mean_next, cov_next = kf_update(state.cov, state.mean, H, R, z, jitter=jitter)

        new_pos = self.actions_xyz[action_idx]
        cost = travel_costs(new_pos, state.pos, self.cfg.uav.max_v, self.cfg.uav.max_a)
        return state.replace(
            mean=mean_next,
            cov=cov_next,
            pos=torch.where(act[:, None], new_pos, state.pos),
            budget=torch.where(act, state.budget - cost, state.budget),
            step=torch.where(act, state.step + 1, state.step),
        )

    # ------------------------------------------------------------------ eval

    def evaluate(self, state: BeliefState) -> Dict[str, torch.Tensor]:
        """All quality metrics for the batch, each (B,) on the device
        (reference planning/missions.py:176-203)."""
        cfg = self.cfg
        gt = state.ground_truth
        est = state.mean
        diag = torch.diagonal(state.cov, dim1=-2, dim2=-1)
        mask = (gt >= cfg.scenario.value_threshold) if cfg.scenario.adaptive else None
        out = {
            "rmse": metrics_ops.rmse(gt, est, mask),
            "wrmse": metrics_ops.weighted_rmse(gt, est),
            "mll": metrics_ops.mean_log_loss(gt, est, diag),
            "wmll": metrics_ops.weighted_mean_log_loss(gt, est, diag),
            "uncertainty": metrics_ops.map_uncertainty(diag, mask),
        }
        if cfg.scenario.adaptive:
            out["uncertainty_difference"] = metrics_ops.map_uncertainty_difference(
                diag, mask
            )
        return out
