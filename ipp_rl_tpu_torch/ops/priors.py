"""Belief priors: Matérn GP covariance (closed form) and random SPD.

Port of ``ipp_rl_tpu/ops/priors.py``.  The reference's unfitted sklearn
GP prior over the cell centres is the Matérn kernel matrix (reference
mapping/mappings.py:236-261).  The randomised priors take their draws as
arguments (uniform draws in [0, 1), standard-normal matrices), so a test
can hand both packages the same numbers; ``env/world.IPPWorld`` draws
them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import Config
from ipp_rl_tpu_torch.device import resolve_device


def cell_center_distances(cfg: Config) -> np.ndarray:
    """(N, N) pairwise distances between grid cell centres, row-major
    ordering (reference mapping/mappings.py:248-256)."""
    env = cfg.environment
    rows, cols = np.meshgrid(np.arange(env.y_dim), np.arange(env.x_dim), indexing="ij")
    pts = (
        np.stack([rows.ravel(), cols.ravel()], axis=1).astype(np.float64)
        * env.resolution
        + 0.5 * env.resolution
    )
    diff = pts[:, None, :] - pts[None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


def matern_kernel(
    dists: torch.Tensor,
    signal_variance: torch.Tensor | float,
    length_scale: torch.Tensor | float,
    nu: float,
) -> torch.Tensor:
    """Matérn covariance, closed forms for ν ∈ {0.5, 1.5, 2.5}.

    ν = 1.5: σ²(1 + √3 d/ℓ)·exp(−√3 d/ℓ) — the canonical config.
    """
    if nu == 0.5:
        k = torch.exp(-dists / length_scale)
    elif nu == 1.5:
        s = math.sqrt(3.0) * dists / length_scale
        k = (1.0 + s) * torch.exp(-s)
    elif nu == 2.5:
        s = math.sqrt(5.0) * dists / length_scale
        k = (1.0 + s + s * s / 3.0) * torch.exp(-s)
    else:
        raise NotImplementedError(f"Matérn ν={nu} has no closed form here")
    return signal_variance * k


def gp_prior_cov(
    cfg: Config,
    signal_variance: torch.Tensor | float | None = None,
    length_scale: torch.Tensor | float | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(N, N) GP prior covariance over cell centres; with (B,)-shaped
    hyper-parameters, a (B, N, N) batch."""
    m = cfg.mapping
    sv = m.signal_variance if signal_variance is None else signal_variance
    ls = m.length_scale if length_scale is None else length_scale
    dists = torch.as_tensor(cell_center_distances(cfg), dtype=dtype,
                            device=resolve_device(device))
    if isinstance(sv, torch.Tensor) and sv.ndim:
        sv = sv[..., None, None]
    if isinstance(ls, torch.Tensor) and ls.ndim:
        ls = ls[..., None, None]
    return matern_kernel(dists, sv, ls, m.nu)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map unit draws u ∈ [0, 1) onto [lo, hi) as jax.random.uniform does."""
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def shuffled_gp_prior_cov(cfg: Config, unit_draws: torch.Tensor) -> torch.Tensor:
    """Per-episode randomized prior: hyper-params U[0.8, 1.2]×nominal
    (reference mapping/mappings.py:238-240).  ``unit_draws`` (..., 2) in
    [0, 1): signal variance, length scale."""
    m = cfg.mapping
    sv = _uniform(unit_draws[..., 0], 0.8 * m.signal_variance, 1.2 * m.signal_variance)
    ls = _uniform(unit_draws[..., 1], 0.8 * m.length_scale, 1.2 * m.length_scale)
    return gp_prior_cov(cfg, sv, ls, unit_draws.device, unit_draws.dtype)


def random_spd_prior_cov(
    cfg: Config, normal: torch.Tensor, unit_draw: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Random SPD prior A·Aᵀ/‖A‖_F with A ~ N(prior_cov_mean, prior_cov_std)
    (reference mapping/mappings.py:219-234).  ``normal`` (..., N, N) are
    standard-normal draws; with ``unit_draw`` (...) the mean and std are
    shuffled to U[0.1, prior_cov_mean) per episode."""
    m = cfg.mapping
    if unit_draw is not None:
        mean = _uniform(unit_draw, 0.1, m.prior_cov_mean)[..., None, None]
        std = mean
    else:
        mean, std = m.prior_cov_mean, m.prior_cov_std
    A = mean + std * normal
    fro = torch.sqrt(torch.sum(A * A, dim=(-2, -1)))[..., None, None]
    return (A @ A.mT) / fro


def init_belief(
    cfg: Config,
    shuffle: bool = False,
    unit_draws: Optional[torch.Tensor] = None,
    normal: Optional[torch.Tensor] = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior (mean (N,), cov (N, N)): mean ≡ 0.5; covariance from the GP
    kernel or a random SPD matrix per config (reference
    mapping/mappings.py:217-261).  The shuffled GP prior needs
    ``unit_draws`` (..., 2); the random SPD prior needs ``normal``
    (..., N, N) and, shuffled, ``unit_draws`` (...)."""
    n = cfg.environment.num_cells
    device = resolve_device(device)
    mean = torch.full((n,), 0.5, dtype=dtype, device=device)
    if cfg.mapping.fit_gaussian_process:
        if shuffle:
            if unit_draws is None:
                raise ValueError("the shuffled GP prior needs unit_draws")
            cov = shuffled_gp_prior_cov(cfg, unit_draws)
        else:
            cov = gp_prior_cov(cfg, device=device, dtype=dtype)
    else:
        if normal is None:
            raise ValueError("the random SPD prior needs normal draws")
        cov = random_spd_prior_cov(cfg, normal, unit_draws if shuffle else None)
    return mean, cov
