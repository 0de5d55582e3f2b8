"""Action lattice, FoV projection, and travel-cost functions.

Port of ``ipp_rl_tpu/ops/geometry.py``.  The lattice and FoV projection
are config-static host precompute in numpy; the cost functions are torch,
broadcasting over leading batch axes so one call prices every
(mission, action) pair.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config


@dataclass(frozen=True)
class ActionLattice:
    """Static action set: index ``a = h * num_cells + (x_idx * y_dim + y_idx)``
    (x-major cell enumeration, as in the JAX package); grid CELLS stay
    row-major (``cell = y_idx * x_dim + x_idx``).

    Attributes:
        xyz: (A, 3) float64 world positions of each action (cell centers, altitude).
        altitude_level: (A,) int32 altitude level per action.
        cell_index: (A,) int32 flattened row-major grid cell per action.
        num_cells: number of grid cells N.
        num_levels: number of altitude levels.
    """

    xyz: np.ndarray
    altitude_level: np.ndarray
    cell_index: np.ndarray
    num_cells: int
    num_levels: int

    @property
    def num_actions(self) -> int:
        return self.xyz.shape[0]


def build_action_lattice(cfg: Config) -> ActionLattice:
    """Enumerate the full measurement-position lattice from config."""
    env, con = cfg.environment, cfg.constraints
    levels = np.linspace(con.min_altitude, con.max_altitude, con.altitude_levels)
    res = env.resolution
    cols, rows = np.meshgrid(np.arange(env.x_dim), np.arange(env.y_dim), indexing="ij")
    x = cols.ravel() * res + 0.5 * res
    y = rows.ravel() * res + 0.5 * res
    cell_idx = (rows.ravel() * env.x_dim + cols.ravel()).astype(np.int32)

    xyz = np.concatenate(
        [np.stack([x, y, np.full_like(x, z)], axis=1) for z in levels], axis=0
    )
    altitude_level = np.repeat(
        np.arange(con.altitude_levels, dtype=np.int32), env.num_cells
    )
    cell_index = np.tile(cell_idx, con.altitude_levels)
    return ActionLattice(
        xyz=xyz,
        altitude_level=altitude_level,
        cell_index=cell_index,
        num_cells=env.num_cells,
        num_levels=con.altitude_levels,
    )


def euclidean_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a − b‖₂ along the trailing xyz axis; broadcasts leading axes."""
    return torch.sqrt(torch.sum(torch.square(a - b), dim=-1))


def flight_times(
    a: torch.Tensor, b: torch.Tensor, max_v: float, max_a: float
) -> torch.Tensor:
    """Trapezoidal velocity-profile flight time between positions:
    accelerate at ``max_a`` to ``max_v``, cruise, decelerate — clipped to a
    triangular profile for short hops (reference
    planning/common/actions.py:19-41)."""
    dist = euclidean_distances(a, b)
    d_acc = torch.clamp(0.5 * dist, max=max_v * max_v / (2.0 * max_a))
    d_const = dist - 2.0 * d_acc
    t_acc = torch.sqrt(2.0 * d_acc / max_a)
    t_const = d_const / max_v
    return t_const + 2.0 * t_acc


def travel_costs(
    a: torch.Tensor,
    b: torch.Tensor,
    max_v: Optional[float] = None,
    max_a: Optional[float] = None,
) -> torch.Tensor:
    """Step cost: flight time when UAV dynamics are given, else distance
    (reference planning/common/actions.py:8-12)."""
    if max_v is None or max_a is None:
        return euclidean_distances(a, b)
    return flight_times(a, b, max_v, max_a)


def project_field_of_view(
    position: np.ndarray, cfg: Config
) -> Tuple[int, int, int, int]:
    """Project the camera FoV footprint to a clipped grid-cell rectangle
    (reference sensors/cameras.py:44-75).  Host-side precompute.

    Returns (xl, xr, yu, yd) inclusive cell bounds.
    """
    env, sensor = cfg.environment, cfg.sensor
    h = float(position[2])
    range_x_m = 2.0 * h * math.tan(0.5 * math.radians(sensor.angle_x))
    range_y_m = 2.0 * h * math.tan(0.5 * math.radians(sensor.angle_y))
    range_x_cells = math.floor(range_x_m / env.resolution)
    range_y_cells = math.floor(range_y_m / env.resolution)
    col = math.floor(position[0] / env.resolution)
    row = math.floor(position[1] / env.resolution)
    rad_x = math.floor(0.5 * range_x_cells)
    rad_y = math.floor(0.5 * range_y_cells)
    xl = int(np.clip(col - rad_x, 0, env.x_dim - 1))
    xr = int(np.clip(col + rad_x, 0, env.x_dim - 1))
    yu = int(np.clip(row - rad_y, 0, env.y_dim - 1))
    yd = int(np.clip(row + rad_y, 0, env.y_dim - 1))
    return xl, xr, yu, yd


def resolution_factor(altitude: float) -> int:
    """Altitude-dependent sensor downsampling factor
    (reference sensors/cameras.py:122-125)."""
    return 2 if altitude > 10.0 else 1


def out_of_bounds(waypoint: torch.Tensor, cfg: Config) -> torch.Tensor:
    """True where a waypoint leaves the map box or the altitude band
    (reference planning/common/actions.py:102-106).  Broadcasts leading axes."""
    env, con = cfg.environment, cfg.constraints
    in_x = (waypoint[..., 0] >= 0) & (waypoint[..., 0] <= env.extent_x)
    in_y = (waypoint[..., 1] >= 0) & (waypoint[..., 1] <= env.extent_y)
    in_z = (waypoint[..., 2] >= con.min_altitude) & (
        waypoint[..., 2] <= con.max_altitude
    )
    return ~(in_x & in_y & in_z)
