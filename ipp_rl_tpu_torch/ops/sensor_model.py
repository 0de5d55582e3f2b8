"""Config-static measurement-model precompute: the ActionTable.

Port of ``ipp_rl_tpu/ops/sensor_model.py`` — numpy only, so both
packages build exactly equal arrays (tests/test_torch_world.py).  Every
per-action quantity is precomputed once on the host and moved to the
device by ``env/world.IPPWorld``:

  * ``H``      (A, M, N)  measurement model rows (pad rows all-zero),
  * ``R_diag`` (A, M)     measurement noise variances (pad entries 1.0 so
                          the padded innovation stays SPD and the padded
                          gain columns vanish exactly),
  * ``Z``      (A, M, N)  exact area-average synthesis matrix used by the
                          world simulation to generate observations,
  * masks, FoV footprints, pairwise costs, and valid-action geometry,

plus the SweepPlan that groups the lattice for the all-action sweep
(ops/kalman.kf_sweep_gains_batched).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.ops.geometry import (
    ActionLattice,
    build_action_lattice,
    project_field_of_view,
    resolution_factor,
)


def altitude_noise_variance(altitude: float, coeff_a: float, coeff_b: float) -> float:
    """σ²(h) = a·(1 − e^{−b·h}) (reference sensors/models/sensor_models.py:27-30)."""
    return coeff_a * (1.0 - math.exp(-coeff_b * altitude))


@dataclass(frozen=True)
class ActionTable:
    """All static per-action planner data.  Arrays are numpy (host);
    ``IPPWorld`` copies the ones the hot path reads to the device."""

    lattice: ActionLattice
    # Measurement model (Kalman): shapes (A, M, N) / (A, M)
    H: np.ndarray
    R_diag: np.ndarray
    meas_valid: np.ndarray  # (A, M) bool — True for real measurement rows
    num_meas: np.ndarray  # (A,) int32
    # World-simulation synthesis: exact area-average of ground truth per
    # measurement pixel (A, M, N), plus per-action noise std (A,)
    Z: np.ndarray
    noise_std: np.ndarray
    # Geometry
    fov_mask: np.ndarray  # (A, N) bool — grid cells inside the FoV footprint
    fov_rect: np.ndarray  # (A, 4) int32 — (xl, xr, yu, yd) inclusive
    res_factor: np.ndarray  # (A,) int32
    # Pairwise action geometry (A, A)
    pair_dist: np.ndarray
    pair_cost: np.ndarray  # flight-time cost with the configured UAV

    @property
    def num_actions(self) -> int:
        return self.lattice.num_actions

    @property
    def max_meas(self) -> int:
        return self.H.shape[1]


def _fov_measurement_layout(
    xl: int, xr: int, yu: int, yd: int, rf: int
) -> Tuple[int, int, int]:
    """Number of measurement pixels (rows in H) covering the FoV rect when
    downsampled by ``rf`` (reference mapping/mappings.py:126)."""
    w = xr - xl + 1
    h = yd - yu + 1
    nx = math.ceil(w / rf)
    ny = math.ceil(h / rf)
    return nx, ny, nx * ny


def _action_measurement_model(
    cfg: Config, xl: int, xr: int, yu: int, yd: int, rf: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (m, N) H and (m, N) Z for one action.

    H semantics follow the reference exactly (reference
    sensors/models/sensor_models.py:54-81): measurement pixel i covers the
    rf×rf block of FoV cells starting at (rf·(i % nx), rf·(i // nx)),
    clipped at the FoV edge; every covered cell gets weight 1/rf², except
    partial blocks (fewer than rf² cells) where the weight is 1/rf.

    Z gives the *exact block mean* (weight 1/k for a k-cell block) — the
    physically consistent synthesis operator for the simulated camera
    (reference downsamples via cv2 INTER_AREA,
    simulations/sensor_manipulations.py:7-26).
    """
    x_dim = cfg.environment.x_dim
    n = cfg.environment.num_cells
    nx, ny, m = _fov_measurement_layout(xl, xr, yu, yd, rf)
    w = xr - xl + 1
    h = yd - yu + 1
    H = np.zeros((m, n), dtype=np.float64)
    Z = np.zeros((m, n), dtype=np.float64)
    for i in range(m):
        by = i // nx
        bx = i % nx
        x0, x1 = bx * rf, min(bx * rf + rf, w)
        y0, y1 = by * rf, min(by * rf + rf, h)
        cells = [
            (yu + yy) * x_dim + (xl + xx)
            for yy in range(y0, y1)
            for xx in range(x0, x1)
        ]
        k = len(cells)
        weight = 1.0 / (rf * rf) if k == rf * rf else 1.0 / rf
        H[i, cells] = weight
        Z[i, cells] = 1.0 / k
    return H, Z


@dataclass(frozen=True)
class SweepGroup:
    """One resolution-factor group of the action lattice for the
    all-action sweep (ops/kalman.kf_sweep_gains_batched).

    Exactly one of (``cells``, ``H``) is set:
      * ``cells`` — gather path (rf == 1): every valid H row is a one-hot
        cell indicator with weight 1, so innovation/gain blocks are pure
        gathers from P and Q = P·diag(m)·P;
      * ``H``     — dense path (rf > 1): group-local (Ag, Mg, N) rows
        with Mg = the group's own max measurement count (much smaller
        than the global pad, shrinking the streamed P·Hᵀ intermediate).
    """

    idx: np.ndarray  # (Ag,) int32 — action indices in lattice order
    R: np.ndarray  # (Ag, Mg) noise diag (pad rows 1.0)
    valid: np.ndarray  # (Ag, Mg) bool
    cells: np.ndarray | None = None  # (Ag, Mg) int32 cell per row
    H: np.ndarray | None = None  # (Ag, Mg, N)
    # Window metadata: set when every action's measurement cells are
    # exactly the (2r+1)×(2r+1) grid window centred on the action's cell,
    # clipped at the grid border.  The sweep then gathers each block over
    # the full window (out-of-grid slots padded), in the JAX package's
    # slot order.
    win_radius: int | None = None
    win_centers: np.ndarray | None = None  # (Ag,) int32 centre cell
    win_R: np.ndarray | None = None  # (Ag,) scalar noise per action


@dataclass(frozen=True)
class SweepPlan:
    """Static grouping of the lattice for the all-action sweep."""

    groups: Tuple[SweepGroup, ...]
    perm: np.ndarray  # (A,) int32: gains_lattice = concat(group gains)[perm]
    needs_q: bool  # any gather group present → Q = P·diag(m)·P required
    x_dim: int | None = None  # grid dims (window detection)
    y_dim: int | None = None


def _detect_window(
    table: ActionTable, idx: np.ndarray, cells: np.ndarray, x_dim: int, y_dim: int
):
    """Return (radius, centers (Ag,), R (Ag,)) if every action in ``idx``
    measures exactly the (2r+1)×(2r+1) grid window centred on its own
    cell (clipped at the grid border) with one-hot weight-1 rows —
    the geometry of the rf==1 lattice — else None."""
    if len(idx) == 0:
        return None
    rects = table.fov_rect[idx]  # (Ag, 4): xl, xr, yu, yd
    centers = table.lattice.cell_index[idx].astype(np.int32)
    cy, cx = centers // x_dim, centers % x_dim
    w = int((rects[:, 1] - rects[:, 0]).max()) + 1
    wy = int((rects[:, 3] - rects[:, 2]).max()) + 1
    w = max(w, wy)
    if w % 2 != 1:
        return None
    r = (w - 1) // 2
    if r < 1:
        return None
    ok = (
        np.all(rects[:, 0] == np.maximum(cx - r, 0))
        and np.all(rects[:, 1] == np.minimum(cx + r, x_dim - 1))
        and np.all(rects[:, 2] == np.maximum(cy - r, 0))
        and np.all(rects[:, 3] == np.minimum(cy + r, y_dim - 1))
    )
    if not ok:
        return None
    # the measured cells must be exactly the clipped window's cells
    nm = np.asarray(table.num_meas)[idx]
    exp = (rects[:, 1] - rects[:, 0] + 1) * (rects[:, 3] - rects[:, 2] + 1)
    if not np.all(nm == exp):
        return None
    for a in range(len(idx)):
        want = {
            int((yy) * x_dim + xx)
            for yy in range(rects[a, 2], rects[a, 3] + 1)
            for xx in range(rects[a, 0], rects[a, 1] + 1)
        }
        got = set(int(c) for c in cells[a, : nm[a]])
        if want != got:
            return None
    R = table.R_diag[idx, 0].astype(np.float64)  # all rows share the value
    if not np.all(
        np.where(
            np.asarray(table.meas_valid)[idx],
            table.R_diag[idx],
            R[:, None],
        )
        == R[:, None]
    ):
        return None
    return r, centers, R


def build_sweep_plan(
    table: ActionTable, x_dim: int | None = None, y_dim: int | None = None
) -> SweepPlan:
    """Group actions by resolution factor; rf==1 groups become gather
    groups (one-hot rows), rf>1 groups dense with group-local padding.

    With grid dims given, rf==1 groups whose measurement cells are the
    centred window pattern additionally carry window metadata for the
    batched sweep (ops/kalman.kf_sweep_gains_batched);
    groups mixing several FoV radii (multiple low altitudes) are split
    per altitude level so each subgroup has one radius."""
    A = table.num_actions
    rfs = np.asarray(table.res_factor)
    levels = np.asarray(table.lattice.altitude_level)
    groups = []
    order = []

    def make_group(idx):
        mg = int(table.num_meas[idx].max())
        H_g = table.H[idx, :mg]  # (Ag, Mg, N)
        R_g = table.R_diag[idx, :mg]
        valid_g = table.meas_valid[idx, :mg]
        one_hot_ok = False
        if int(rfs[idx[0]]) == 1:
            # valid rows must be exact one-hot weight-1 indicators
            row_sums = H_g.sum(axis=-1)
            row_max = H_g.max(axis=-1)
            one_hot_ok = bool(
                np.all(np.where(valid_g, row_sums, 1.0) == 1.0)
                and np.all(np.where(valid_g, row_max, 1.0) == 1.0)
            )
        if one_hot_ok:
            cells = np.argmax(H_g, axis=-1).astype(np.int32)
            cells = np.where(valid_g, cells, 0)
            win = None
            if x_dim is not None and y_dim is not None:
                win = _detect_window(table, idx, cells, x_dim, y_dim)
            if win is not None:
                r, centers, R_a = win
                return SweepGroup(
                    idx=idx, R=R_g, valid=valid_g, cells=cells,
                    win_radius=r, win_centers=centers, win_R=R_a,
                )
            return SweepGroup(idx=idx, R=R_g, valid=valid_g, cells=cells)
        return SweepGroup(idx=idx, R=R_g, valid=valid_g, H=H_g)

    for rf in sorted(set(int(r) for r in rfs)):
        idx = np.nonzero(rfs == rf)[0].astype(np.int32)
        g = make_group(idx)
        if rf == 1 and g.cells is not None and g.win_radius is None:
            # mixed radii? retry per altitude level
            subs = [
                make_group(idx[levels[idx] == lv])
                for lv in sorted(set(int(v) for v in levels[idx]))
            ]
            if any(s.win_radius is not None for s in subs):
                for s in subs:
                    groups.append(s)
                    order.append(s.idx)
                continue
        groups.append(g)
        order.append(idx)
    order = np.concatenate(order) if order else np.zeros((0,), np.int32)
    perm = np.empty((A,), dtype=np.int32)
    perm[order] = np.arange(A, dtype=np.int32)
    # perm maps lattice index -> position in the concatenated group output
    needs_q = any(g.cells is not None for g in groups)
    return SweepPlan(
        groups=tuple(groups), perm=perm, needs_q=needs_q,
        x_dim=x_dim, y_dim=y_dim,
    )


def build_action_table(cfg: Config) -> ActionTable:
    """Precompute the full per-action measurement-model table from config."""
    lattice = build_action_lattice(cfg)
    sensor = cfg.sensor
    n = cfg.environment.num_cells
    a_count = lattice.num_actions

    rects = np.zeros((a_count, 4), dtype=np.int32)
    rfs = np.zeros((a_count,), dtype=np.int32)
    num_meas = np.zeros((a_count,), dtype=np.int32)
    h_list, z_list = [], []
    for a in range(a_count):
        pos = lattice.xyz[a]
        xl, xr, yu, yd = project_field_of_view(pos, cfg)
        rf = resolution_factor(pos[2])
        rects[a] = (xl, xr, yu, yd)
        rfs[a] = rf
        H_a, Z_a = _action_measurement_model(cfg, xl, xr, yu, yd, rf)
        num_meas[a] = H_a.shape[0]
        h_list.append(H_a)
        z_list.append(Z_a)

    m_max = int(num_meas.max())
    H = np.zeros((a_count, m_max, n), dtype=np.float64)
    Z = np.zeros((a_count, m_max, n), dtype=np.float64)
    R_diag = np.ones((a_count, m_max), dtype=np.float64)
    meas_valid = np.zeros((a_count, m_max), dtype=bool)
    noise_std = np.zeros((a_count,), dtype=np.float64)
    for a in range(a_count):
        m = num_meas[a]
        H[a, :m] = h_list[a]
        Z[a, :m] = z_list[a]
        var = altitude_noise_variance(
            float(lattice.xyz[a, 2]), sensor.coeff_a, sensor.coeff_b
        )
        # R = rf³ · σ²(h) · I (reference sensors/models/sensor_models.py:32-36)
        R_diag[a, :m] = (rfs[a] ** 3) * var
        meas_valid[a, :m] = True
        # Simulated-noise scale: the reference passes get_noise_variance
        # as np.random.normal's ``scale`` parameter (which is a STD, not
        # a variance — simulations/sensor_manipulations.py:57-58), with
        # no rf³ factor.  Reproduce that exact injected magnitude so
        # map-RMSE matches the reference's missions (PARITY.md §14);
        # the filter's R above keeps the reference's rf³·σ² quirk too.
        noise_std[a] = var

    fov_mask = np.zeros((a_count, n), dtype=bool)
    x_dim = cfg.environment.x_dim
    for a in range(a_count):
        xl, xr, yu, yd = rects[a]
        for yy in range(yu, yd + 1):
            fov_mask[a, yy * x_dim + xl : yy * x_dim + xr + 1] = True

    diff = lattice.xyz[:, None, :] - lattice.xyz[None, :, :]
    pair_dist = np.sqrt(np.sum(diff * diff, axis=-1))
    uav = cfg.uav
    d_acc = np.minimum(0.5 * pair_dist, uav.max_v**2 / (2.0 * uav.max_a))
    d_const = pair_dist - 2.0 * d_acc
    pair_cost = d_const / uav.max_v + 2.0 * np.sqrt(2.0 * d_acc / uav.max_a)

    return ActionTable(
        lattice=lattice,
        H=H,
        R_diag=R_diag,
        meas_valid=meas_valid,
        num_meas=num_meas,
        Z=Z,
        noise_std=noise_std,
        fov_mask=fov_mask,
        fov_rect=rects,
        res_factor=rfs,
        pair_dist=pair_dist,
        pair_cost=pair_cost,
    )
