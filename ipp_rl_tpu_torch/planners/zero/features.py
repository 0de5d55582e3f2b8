"""Network input feature planes (reference planning/common/features.py).

Port of ``ipp_rl_tpu/planners/zero/features.py``, batched over missions
explicitly (the JAX package vmaps one mission's functions).  The CNN
consumes covariance-matrix-sized planes, each channel (N, N) with
N = num_grid_cells.  Per history step (most recent first):

    [min-max-normalised covariance state (adaptive rows/cols zeroed),
     x/extent, y/extent, (z − zmin)/(zmax − zmin), budget fraction]

zero-padded for missing history, then one action-cost plane (row i = the
normalised cost from the current position, at min altitude, to cell i):
5·L + 1 = 16 channels on the canonical config (3·L + 1 with FoV planes).

History is a fixed-shape ring: (B, L, N, N) covariance states plus
(B, L, 3) positions, (B, L) budget fractions and (B,) lengths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ipp_rl_tpu_torch.config.schema import Config, MCTSZeroHyperParams
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask


@dataclasses.dataclass
class EpisodeHistory:
    """Most-recent-first ring of belief snapshots, batched over missions."""

    covs: torch.Tensor  # (B, L, N, N)
    positions: torch.Tensor  # (B, L, 3)
    budgets: torch.Tensor  # (B, L) — budget fraction of initial
    length: torch.Tensor  # (B,) int32 — number of valid entries

    def replace(self, **changes) -> "EpisodeHistory":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "EpisodeHistory":
        """``fn`` applied to every field (each has the mission axis first)."""
        return EpisodeHistory(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def init_history(
    cfg: Config,
    hp: MCTSZeroHyperParams,
    batch_size: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> EpisodeHistory:
    L, n, B = hp.input_history_length, cfg.environment.num_cells, batch_size
    device = resolve_device(device)
    return EpisodeHistory(
        covs=torch.zeros((B, L, n, n), dtype=dtype, device=device),
        positions=torch.zeros((B, L, 3), dtype=dtype, device=device),
        budgets=torch.zeros((B, L), dtype=dtype, device=device),
        length=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def push_history(
    h: EpisodeHistory, cov: torch.Tensor, pos: torch.Tensor, budget_frac: torch.Tensor
) -> EpisodeHistory:
    """Insert at the front, evicting the oldest (reference features.py:18-26).
    cov (B, N, N), pos (B, 3), budget_frac (B,)."""
    L = h.covs.shape[1]
    return EpisodeHistory(
        covs=torch.cat([cov[:, None].to(h.covs.dtype), h.covs[:, :-1]], dim=1),
        positions=torch.cat([pos[:, None].to(h.positions.dtype), h.positions[:, :-1]], dim=1),
        budgets=torch.cat([budget_frac[:, None].to(h.budgets.dtype), h.budgets[:, :-1]], dim=1),
        length=torch.clamp(h.length + 1, max=L),
    )


def fov_cell_mask(cfg: Config, pos: torch.Tensor) -> torch.Tensor:
    """The FoV footprint (..., N) bool at arbitrary positions (..., 3), by
    the reference's projection rules (reference sensors/cameras.py:49-75).

    Two reference quirks are kept (features.py:154-166 of the reference):
    the footprint drops the LAST row and column of the projected FoV, and
    the flat index is x·y_dim + y, transposed against the H-matrix
    convention."""
    env, sensor = cfg.environment, cfg.sensor
    z = pos[..., 2]
    range_x = torch.floor(2.0 * z * math.tan(0.5 * math.radians(sensor.angle_x)) / env.resolution)
    range_y = torch.floor(2.0 * z * math.tan(0.5 * math.radians(sensor.angle_y)) / env.resolution)
    col = torch.floor(pos[..., 0] / env.resolution)
    row = torch.floor(pos[..., 1] / env.resolution)
    rad_x = torch.floor(0.5 * range_x)
    rad_y = torch.floor(0.5 * range_y)
    xl = torch.clamp(col - rad_x, 0, env.x_dim - 1)[..., None]
    xr = torch.clamp(col + rad_x, 0, env.x_dim - 1)[..., None]
    yu = torch.clamp(row - rad_y, 0, env.y_dim - 1)[..., None]
    yd = torch.clamp(row + rad_y, 0, env.y_dim - 1)[..., None]
    cols = torch.arange(env.x_dim, device=pos.device)
    rows = torch.arange(env.y_dim, device=pos.device)
    mx = (cols >= xl) & (cols <= xr - 1)
    my = (rows >= yu) & (rows <= yd - 1)
    return (mx[..., :, None] & my[..., None, :]).flatten(-2)


def min_max_normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-matrix min-max normalisation over the last two axes, with the
    JAX package's degenerate rules: a constant matrix becomes x / max
    (x itself when that max is 0)."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    same = hi == lo
    safe_hi = torch.where(same & (hi == 0), torch.ones_like(hi), hi)
    return torch.where(same, x / safe_hi, (x - lo) / (hi - lo))


def feature_planes(
    world,
    hp: MCTSZeroHyperParams,
    history: EpisodeHistory,
    mean: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, N, N, C) feature planes in the JAX package's NHWC layout.

    The planes are built channel-major, (B, C, N, N), and returned as an
    NHWC view of that memory, so the network's NCHW permute at its input
    is free.  ``mean`` (B, N) is the current belief mean, needed for the
    adaptive mask (reference features.py:94-99)."""
    cfg = world.cfg
    env, con, scen = cfg.environment, cfg.constraints, cfg.scenario
    B, L, n, _ = history.covs.shape
    dt = history.covs.dtype
    dev = history.covs.device

    valid = (torch.arange(L, device=dev) < history.length[:, None]).to(dt)  # (B, L)
    states = history.covs
    if scen.adaptive and mean is not None:
        diag = torch.diagonal(states, dim1=-2, dim2=-1)  # (B, L, N)
        m = adaptive_mask(mean[:, None, :], diag, scen.value_threshold, scen.interval_factor)
        states = states * m[..., :, None] * m[..., None, :]
    states = min_max_normalize(states)

    if hp.use_fov_input:
        fov = fov_cell_mask(cfg, history.positions).to(dt)  # (B, L, N)
        per_step = [states, fov[..., :, None] * fov[..., None, :], history.budgets]
    else:
        per_step = [
            states,
            history.positions[..., 0] / env.extent_x,
            history.positions[..., 1] / env.extent_y,
            (history.positions[..., 2] - con.min_altitude) / (con.max_altitude - con.min_altitude),
            history.budgets,
        ]
    K = len(per_step)
    C = K * L + int(hp.use_action_costs_input)
    planes = torch.empty((B, C, n, n), dtype=dt, device=dev)
    step_planes = planes[:, : K * L].view(B, L, K, n, n)
    for k, p in enumerate(per_step):
        p = p * (valid[..., None, None] if p.ndim == 4 else valid)  # zero-pad short history
        step_planes[:, :, k] = p if p.ndim == 4 else p[..., None, None]

    if hp.use_action_costs_input:
        # row i = travel cost from the current position (altitude pinned
        # to min_altitude) to cell centre i at min_altitude, min-max
        # normalised per mission (reference features.py:61-70)
        cur = history.positions[:, 0].clone()
        cur[:, 2] = con.min_altitude
        cells = world.actions_xyz[: env.num_cells].clone()
        cells[:, 2] = con.min_altitude
        costs = travel_costs(cells, cur[:, None, :], cfg.uav.max_v, cfg.uav.max_a)  # (B, N)
        costs = min_max_normalize(costs[:, None, :])[:, 0].to(dt)
        planes[:, -1] = costs[:, :, None]
    return planes.permute(0, 2, 3, 1)
