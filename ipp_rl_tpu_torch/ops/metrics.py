"""Map-quality evaluation metrics (reference planning/evaluation_metrics.py:4-58).

Port of ``ipp_rl_tpu/ops/metrics.py``: reductions over (ground truth,
belief mean, covariance diagonal), each (…, N) → (…).  Masked variants
weight instead of selecting: mean over masked entries = Σ m·x / Σ m.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x, dim=-1)
    m = mask.to(x.dtype)
    return torch.sum(x * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)


def _gt_weights(ground_truth: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    gt_range = torch.amax(ground_truth, dim=-1, keepdim=True) - torch.amin(
        ground_truth, dim=-1, keepdim=True
    )
    w = (ground_truth - torch.amin(estimate, dim=-1, keepdim=True)) / gt_range
    return w / torch.sum(w, dim=-1, keepdim=True)


def _log_loss(ground_truth, estimate, cov_diag):
    # the reference's exact expression, including the (err²/2)·σ² scaling
    return 0.5 * torch.log(2.0 * math.pi * cov_diag) + torch.square(
        ground_truth - estimate
    ) / 2.0 * cov_diag


def rmse(
    ground_truth: torch.Tensor,
    estimate: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Root-mean-squared error, optionally over the region of interest
    (reference planning/evaluation_metrics.py:4-13)."""
    return torch.sqrt(_masked_mean(torch.square(ground_truth - estimate), mask))


def weighted_rmse(ground_truth: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Ground-truth-weighted RMSE (reference planning/evaluation_metrics.py:31-36)."""
    w = _gt_weights(ground_truth, estimate)
    return torch.sqrt(torch.mean(w * torch.square(ground_truth - estimate), dim=-1))


def mean_log_loss(
    ground_truth: torch.Tensor, estimate: torch.Tensor, cov_diag: torch.Tensor
) -> torch.Tensor:
    """Mean Gaussian log-loss scaled by per-cell variances
    (reference planning/evaluation_metrics.py:39-45)."""
    return torch.mean(_log_loss(ground_truth, estimate, cov_diag), dim=-1)


def weighted_mean_log_loss(
    ground_truth: torch.Tensor, estimate: torch.Tensor, cov_diag: torch.Tensor
) -> torch.Tensor:
    """Ground-truth-weighted mean log-loss
    (reference planning/evaluation_metrics.py:48-58)."""
    w = _gt_weights(ground_truth, estimate)
    return torch.mean(w * _log_loss(ground_truth, estimate, cov_diag), dim=-1)


def map_uncertainty(
    cov_diag: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """tr(P), optionally restricted to the region of interest
    (reference planning/evaluation_metrics.py:16-21)."""
    if mask is None:
        return torch.sum(cov_diag, dim=-1)
    return torch.sum(cov_diag * mask.to(cov_diag.dtype), dim=-1)


def map_uncertainty_difference(cov_diag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Relative mean-variance gap: uninteresting vs interesting regions
    (reference planning/evaluation_metrics.py:24-28)."""
    m = mask.to(cov_diag.dtype)
    var_in = _masked_mean(cov_diag, m)
    var_out = _masked_mean(cov_diag, 1.0 - m)
    return (var_out - var_in) / var_out
