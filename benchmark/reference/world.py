"""Plain reference of the world: the action lattice, the camera's
measurement model at any position, flight costs, the Kalman commit, the
all-action information gain, and the map metrics.

Written from the reference experiment's semantics (the YAML layout of
``config/example.yaml``, the camera footprint and its down-sampled pixel
blocks, the altitude-dependent noise, a Joseph-form Kalman commit), in
plain PyTorch over the configuration's raw dict.  It imports nothing of
the program and takes nothing the program made: every table is worked
out again here.

``Arith`` sets the precision: float64 is the reference; ``bf16`` rounds
every stored intermediate to bfloat16 (kept in float32 between
operations), the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class Arith:
    """The precision the reference computes in."""

    def __init__(self, kind: str = "float64"):
        if kind not in ("float64", "bf16"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.dtype = torch.float64 if kind == "float64" else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """Round a stored intermediate to the working precision."""
        if self.kind == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x


class RefWorld:
    """The configuration's world, from its raw (YAML-layout) dict."""

    def __init__(self, raw: Dict, device="cpu", arith: Optional[Arith] = None):
        self.raw = raw
        self.arith = arith or Arith()
        self.device = torch.device(device)
        env = raw["environment"]
        exp = raw["experiment"]
        self.x_dim, self.y_dim, self.res = env["x_dim"], env["y_dim"], float(env["resolution"])
        self.n = self.x_dim * self.y_dim
        sensor = raw["sensor"]
        self.angle_x = float(sensor["field_of_view"]["angle_x"])
        self.angle_y = float(sensor["field_of_view"]["angle_y"])
        self.coeff_a = float(sensor["model"]["coeff_a"])
        self.coeff_b = float(sensor["model"]["coeff_b"])
        con = exp["constraints"]
        self.min_alt, self.max_alt = float(con["min_altitude"]), float(con["max_altitude"])
        self.budget = float(con["budget"])
        levels = int((self.max_alt - self.min_alt) / float(con["altitude_spacing"])) + 1
        self.levels = np.linspace(self.min_alt, self.max_alt, levels)
        self.max_v, self.max_a = float(exp["uav"]["max_v"]), float(exp["uav"]["max_a"])
        sc = exp["scenario"]
        self.adaptive = bool(sc["adaptive"])
        self.threshold = float(sc["value_threshold"])
        self.interval = float(sc["interval_factor"])
        # lattice: a = level * N + x_index * y_dim + y_index, cell centres
        xyz = []
        for z in self.levels:
            for xi in range(self.x_dim):
                for yi in range(self.y_dim):
                    xyz.append(((xi + 0.5) * self.res, (yi + 0.5) * self.res, z))
        self.xyz = torch.tensor(xyz, dtype=torch.float64, device=self.device)
        self.num_actions = self.xyz.shape[0]
        H, R, Z, std = self.measurement_model(self.xyz)
        dt = self.arith.dtype
        self.H, self.R, self.Z, self.noise_std = H.to(dt), R.to(dt), Z.to(dt), std.to(dt)

    # ------------------------------------------------------------ camera

    def measurement_model(self, pos: torch.Tensor, rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(H (P, M, N), R (P, M), Z (P, M, N), injected noise scale (P,)) at
        positions pos (P, 3), float64.  The footprint is the camera's
        opening projected from the altitude, in whole cells, clipped to the
        map; above 10 m pixels cover 2 × 2 cells.  Pixel i covers the block
        at (rf·(i mod nx), rf·(i div nx)) of the footprint; H weighs a full
        block's cells 1/rf² and a clipped block's 1/rf, Z averages the
        block's cells.  R = rf³·σ²(z) on real rows and 1 on padding; the
        injected noise scale is σ²(z) (the reference passes the variance as
        the normal's scale).  M is the most pixels of any position given, or
        ``rows``."""
        f64 = torch.float64
        pos = pos.to(self.device, f64)
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
        tx = math.tan(math.radians(self.angle_x) / 2)
        ty = math.tan(math.radians(self.angle_y) / 2)
        rx = torch.floor(2.0 * z * tx / self.res)
        ry = torch.floor(2.0 * z * ty / self.res)
        col, row = torch.floor(x / self.res), torch.floor(y / self.res)
        xl = torch.clamp(col - torch.floor(rx / 2), 0, self.x_dim - 1).long()
        xr = torch.clamp(col + torch.floor(rx / 2), 0, self.x_dim - 1).long()
        yu = torch.clamp(row - torch.floor(ry / 2), 0, self.y_dim - 1).long()
        yd = torch.clamp(row + torch.floor(ry / 2), 0, self.y_dim - 1).long()
        rf = torch.where(z > 10.0, 2, 1).long()
        w, h = xr - xl + 1, yd - yu + 1
        nx, ny = (w + rf - 1) // rf, (h + rf - 1) // rf
        npix = nx * ny
        m = rows or int(npix.max())
        P = pos.shape[0]
        H = torch.zeros((P, m, self.n), dtype=f64, device=self.device)
        Z = torch.zeros_like(H)
        i = torch.arange(m, device=self.device)[None, :]  # (1, m)
        bx, by = i % nx[:, None], i // nx[:, None]
        real = i < npix[:, None]  # (P, m)
        count = torch.zeros((P, m), dtype=f64, device=self.device)
        cells = []
        for dy in range(2):
            for dx in range(2):
                cx, cy = bx * rf[:, None] + dx, by * rf[:, None] + dy
                ok = real & (dx < rf[:, None]) & (dy < rf[:, None]) & (cx < w[:, None]) \
                    & (cy < h[:, None])
                cell = (yu[:, None] + cy) * self.x_dim + (xl[:, None] + cx)
                cells.append((ok, torch.where(ok, cell, 0)))
                count += ok
        full = count == (rf * rf)[:, None]
        hw = torch.where(full, 1.0 / (rf * rf)[:, None], 1.0 / rf[:, None].to(f64))
        zw = torch.where(count > 0, 1.0 / torch.clamp(count, min=1), 0.0)
        for ok, cell in cells:
            H.scatter_add_(-1, cell[..., None], torch.where(ok, hw, 0.0)[..., None])
            Z.scatter_add_(-1, cell[..., None], torch.where(ok, zw, 0.0)[..., None])
        var = self.coeff_a * (1.0 - torch.exp(-self.coeff_b * z))
        R = torch.where(real, (rf ** 3).to(f64)[:, None] * var[:, None], 1.0)
        return H, R, Z, var

    # ------------------------------------------------------------ geometry

    def flight_time(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Trapezoidal speed profile (accelerate at max_a to max_v, cruise,
        brake), triangular on short hops."""
        d = torch.sqrt(torch.sum((a.to(torch.float64) - b.to(torch.float64)) ** 2, dim=-1))
        d_acc = torch.clamp(0.5 * d, max=self.max_v ** 2 / (2.0 * self.max_a))
        return (d - 2.0 * d_acc) / self.max_v + 2.0 * torch.sqrt(2.0 * d_acc / self.max_a)

    def action_index(self, wp: torch.Tensor) -> torch.Tensor:
        """Lattice index of each waypoint (…, 3) (the nearest lattice point)."""
        d = torch.sum((wp.to(torch.float64)[..., None, :] - self.xyz) ** 2, dim=-1)
        return torch.argmin(d, dim=-1)

    def out_of_bounds(self, wp: torch.Tensor) -> torch.Tensor:
        x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]
        inside = ((x >= 0) & (x <= self.x_dim * self.res) & (y >= 0)
                  & (y <= self.y_dim * self.res) & (z >= self.min_alt) & (z <= self.max_alt))
        return ~inside

    # ------------------------------------------------------------ belief

    def roi(self, mean: torch.Tensor, cov: torch.Tensor) -> Optional[torch.Tensor]:
        """The adaptive region of interest as a 0/1 mask over cells."""
        if not self.adaptive:
            return None
        diag = torch.diagonal(cov, dim1=-2, dim2=-1)
        return (mean + self.interval * diag >= self.threshold).to(cov.dtype)

    def commit(self, P, mean, H, R, z):
        """Joseph-form Kalman update of P (S, N, N), mean (S, N) with rows H
        (S, M, N), noise R (S, M) and readings z (S, M)."""
        r = self.arith.r
        HP = r(H @ P)
        S = r(HP @ H.mT)
        S = r(0.5 * (S + S.mT)) + torch.diag_embed(R)
        S_inv = r(torch.linalg.inv(S))
        K = r(HP.mT @ S_inv)  # (S, N, M)
        eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
        IKH = r(eye - K @ H)
        P_new = r(r(IKH @ P) @ IKH.mT) + r(K @ (R[..., None] * K.mT))
        P_new = r(0.5 * (P_new + P_new.mT))
        innov = r(z - (H @ mean[..., None])[..., 0])
        mean_new = r(mean + (K @ innov[..., None])[..., 0])
        return mean_new, P_new

    def gains(self, P, mask, H, R):
        """Information gain Σ_j m_j (P Hᵀ S⁻¹ H P)_jj of measuring with rows H
        (S, A, M, N), R (S, A, M) against beliefs P (S, N, N), mask (S, N)."""
        r = self.arith.r
        PHt = r(P[:, None] @ H.mT)  # (S, A, N, M)
        S = r(H @ PHt)
        S = r(0.5 * (S + S.mT)) + torch.diag_embed(R)
        Y = r(PHt @ r(torch.linalg.inv(S)))
        sq = r(torch.sum(Y * PHt, dim=-1))  # (S, A, N)
        if mask is not None:
            sq = sq * mask[:, None, :]
        return r(torch.sum(sq, dim=-1))

    def reading(self, gt, Z, std, eps):
        """The simulated camera: clip(Z·gt + scale·ε, 0, 1)."""
        clean = (Z @ gt[..., None])[..., 0]
        return self.arith.r(torch.clamp(clean + std[..., None] * eps, 0.0, 1.0))

    def metrics(self, gt, mean, cov) -> Dict[str, torch.Tensor]:
        """Masked tr(P) over the true region of interest, and the RMSE of the
        mean there."""
        diag = torch.diagonal(cov, dim1=-2, dim2=-1)
        m = (gt >= self.threshold).to(cov.dtype) if self.adaptive else torch.ones_like(gt)
        unc = torch.sum(diag * m, dim=-1)
        mse = torch.sum((gt - mean) ** 2 * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)
        return {"uncertainty": unc, "rmse": torch.sqrt(mse)}


def matern_prior(raw: Dict, dtype=torch.float64, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The GP prior over the cell centres: mean 0.5 everywhere and the
    Matérn covariance (ν = 0.5, 1.5 or 2.5) of the configuration."""
    env, mp = raw["environment"], raw["mapping"]
    xd, yd, res = env["x_dim"], env["y_dim"], float(env["resolution"])
    rows, cols = np.meshgrid(np.arange(yd), np.arange(xd), indexing="ij")
    pts = np.stack([rows.ravel(), cols.ravel()], axis=1) * res + 0.5 * res
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    nu, ls, sv = float(mp["nu"]), float(mp["length_scale"]), float(mp["signal_variance"])
    if nu == 0.5:
        k = np.exp(-d / ls)
    elif nu == 1.5:
        s = math.sqrt(3.0) * d / ls
        k = (1.0 + s) * np.exp(-s)
    elif nu == 2.5:
        s = math.sqrt(5.0) * d / ls
        k = (1.0 + s + s * s / 3.0) * np.exp(-s)
    else:
        raise NotImplementedError(f"Matérn nu={nu}")
    n = xd * yd
    cov = torch.tensor(sv * k, dtype=dtype, device=device)
    return torch.full((n,), 0.5, dtype=dtype, device=device), cov
