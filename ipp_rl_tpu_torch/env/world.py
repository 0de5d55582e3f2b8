"""Batched IPP world: belief state + measurement/commit dynamics.

Port of ``ipp_rl_tpu/env/world.py``.  The unit of work is a mission
batch: ``BeliefState`` holds tensors with a leading batch axis B, and
``IPPWorld`` holds the config and the ActionTable constants on its
device, with ``step_index`` (lattice actions, table gathers) and
``step_position`` (continuous waypoints, the measurement model built per
position by ``measurement_model_at``) as the transitions.
Randomness comes from an explicit ``torch.Generator`` or is passed in
(``noise``), so a test can feed both packages the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.fields import generate_ground_truth
from ipp_rl_tpu_torch.ops import metrics as metrics_ops
from ipp_rl_tpu_torch.ops.geometry import (
    project_field_of_view,
    resolution_factor,
    travel_costs,
)
from ipp_rl_tpu_torch.ops.kalman import kf_update, prepare_batched_sweep
from ipp_rl_tpu_torch.ops.priors import init_belief
from ipp_rl_tpu_torch.ops.sensor_model import (
    ActionTable,
    build_action_table,
    build_sweep_plan,
)
from ipp_rl_tpu_torch.utils.tracing import span


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


def _continuous_mmax(cfg: Config) -> int:
    """Upper bound on the measurement rows of any in-band position.

    The FoV grows with altitude; the resolution factor jumps 1→2 above
    10 m (reference sensors/cameras.py:122-125), so the extremes are the
    largest rf=1 FoV (z = min(10, max_alt)) and the max-altitude FoV."""
    env, con = cfg.environment, cfg.constraints
    centre = np.array([env.extent_x / 2, env.extent_y / 2, 0.0])
    m_max = 1
    for z in (min(10.0, con.max_altitude), con.max_altitude, con.min_altitude):
        pos = centre.copy()
        pos[2] = z
        xl, xr, yu, yd = project_field_of_view(pos, cfg)
        rf = resolution_factor(z)
        m = math.ceil((xr - xl + 1) / rf) * math.ceil((yd - yu + 1) / rf)
        m_max = max(m_max, m)
    return m_max


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
        self.m_max_cont = _continuous_mmax(cfg)
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

    # ------------------------------------------------- continuous-pos models

    def measurement_model_at(
        self, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The measurement model at arbitrary positions pos (B, 3): (H (B, M,
        N), R_diag (B, M), Zmat (B, M, N), valid (B, M)) with the padded row
        count M = m_max_cont; padded rows have H = Z = 0 and R = 1.  The
        JAX package's operations in its order and in the world's dtype
        (ipp_rl_tpu/env/world.py:183-250), which reproduce the reference
        FoV projection, clipping and block weights (reference
        sensors/cameras.py:49-75, sensors/models/sensor_models.py:54-81)."""
        cfg = self.cfg
        env, sensor = cfg.environment, cfg.sensor
        n = env.num_cells
        M = self.m_max_cont
        dt, dev = self.dtype, pos.device
        B = pos.shape[0]

        z = pos[:, 2]
        range_x = torch.floor(
            2.0 * z * math.tan(0.5 * math.radians(sensor.angle_x)) / env.resolution)
        range_y = torch.floor(
            2.0 * z * math.tan(0.5 * math.radians(sensor.angle_y)) / env.resolution)
        col = torch.floor(pos[:, 0] / env.resolution)
        row = torch.floor(pos[:, 1] / env.resolution)
        rad_x = torch.floor(0.5 * range_x)
        rad_y = torch.floor(0.5 * range_y)

        def clip_cells(v, hi):
            return torch.clamp(v, 0, hi).to(torch.int64)[:, None, None]  # (B, 1, 1)

        xl, xr = clip_cells(col - rad_x, env.x_dim - 1), clip_cells(col + rad_x, env.x_dim - 1)
        yu, yd = clip_cells(row - rad_y, env.y_dim - 1), clip_cells(row + rad_y, env.y_dim - 1)
        rf = torch.where(z > 10.0, 2, 1)[:, None, None]

        nx = (xr - xl + 1 + rf - 1) // rf  # ceil(w / rf)
        ny = (yd - yu + 1 + rf - 1) // rf
        m = nx * ny

        rows_i = torch.arange(M, device=dev)[None, :, None]  # measurement index
        slot = torch.arange(4, device=dev)[None, None, :]  # block slot 0..3
        by = rows_i // nx
        bx = rows_i - nx * by
        dy = slot // 2
        dx = slot - 2 * dy
        cy = yu + by * rf + dy
        cx = xl + bx * rf + dx
        slot_ok = (dy < rf) & (dx < rf)
        in_fov = (cx <= xr) & (cy <= yd)
        row_ok = rows_i < m  # (B, M, 1)
        cell_ok = slot_ok & in_fov & row_ok  # (B, M, 4)
        k_cells = torch.sum(cell_ok, dim=-1)  # cells per block

        rf2 = rf[..., 0]
        full = k_cells == rf2 * rf2
        # weights in float64, then the world's dtype (1/3 rounds once)
        rf_f = rf2.to(torch.float64)
        h_weight = torch.where(full, 1.0 / (rf_f * rf_f), 1.0 / rf_f).to(dt)
        k_f = torch.clamp(k_cells, min=1).to(torch.float64)
        z_weight = torch.where(k_cells > 0, 1.0 / k_f, 0.0).to(dt)

        # the block's cells (distinct within a row) as a scatter into a
        # dump slot n that is cut off: the JAX package's one-hot sum
        cell = torch.where(cell_ok, cy * env.x_dim + cx, n)  # (B, M, 4)
        block = torch.zeros((B, M, n + 1), dtype=dt, device=dev)
        block.scatter_(-1, cell, 1.0)
        block = block[..., :n]
        H = h_weight[..., None] * block
        Zmat = z_weight[..., None] * block

        valid = row_ok[..., 0]
        var = sensor.coeff_a * (1.0 - torch.exp(-sensor.coeff_b * z))
        R = torch.where(valid, rf2.to(dt) ** 3 * var[:, None], 1.0)
        return H, R, Zmat, valid

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
        with span("plan.commit"):
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

    def step_position(
        self,
        state: BeliefState,
        waypoint: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        jitter: float = 0.0,
    ) -> BeliefState:
        """Take a measurement at continuous waypoints (B, 3) and commit the
        belief update.  Every mission is committed, then inactive ones keep
        their belief, position and budget (ipp_rl_tpu/env/world.py:323-360).
        The injected noise std is the noise VARIANCE, the reference's quirk
        (ops/sensor_model.py); ε (B, M) as in ``step_index``."""
        sensor = self.cfg.sensor
        with span("plan.commit"):
            var = sensor.coeff_a * (1.0 - torch.exp(-sensor.coeff_b * waypoint[:, 2]))
            std = var.to(self.dtype)
            H, R, Zmat, _ = self.measurement_model_at(waypoint)
            z = self.synthesize_measurement(state.ground_truth, Zmat, std, noise, generator)
            mean_next, cov_next = kf_update(state.cov, state.mean, H, R, z, jitter=jitter)
            cost = travel_costs(waypoint, state.pos, self.cfg.uav.max_v, self.cfg.uav.max_a)
            act = state.active
            return state.replace(
                mean=torch.where(act[:, None], mean_next, state.mean),
                cov=torch.where(act[:, None, None], cov_next, state.cov),
                pos=torch.where(act[:, None], waypoint, state.pos),
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
