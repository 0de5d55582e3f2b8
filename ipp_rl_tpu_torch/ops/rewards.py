"""Reward, adaptive-mask and value-target ops (reference
planning/common/rewards.py:8-39).

Port of ``ipp_rl_tpu/ops/rewards.py``.  Reward = information gain per
unit cost: (tr(P) − tr(P')) / (cost + 1), optionally restricted to the
adaptive region of interest; the trace difference comes from the sweep
(ops/kalman.kf_sweep_gains_batched).
"""

from __future__ import annotations

import torch


def adaptive_mask(
    mean_flat: torch.Tensor,
    cov_diag: torch.Tensor,
    value_threshold: float,
    interval_factor: float,
) -> torch.Tensor:
    """Cells whose upper CI bound clears the interest threshold, as a
    float mask (1.0 interesting / 0.0 not) in ``cov_diag``'s dtype
    (reference planning/common/rewards.py:8-12).  Broadcasts leading axes."""
    return (mean_flat + interval_factor * cov_diag >= value_threshold).to(cov_diag.dtype)


def reward_from_gain(gain: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """(tr(P) − tr(P')) / (cost + 1) (reference planning/common/rewards.py:15-31)."""
    return gain / (cost + 1.0)


def scale_value_target(value: torch.Tensor) -> torch.Tensor:
    """√(v + 1) − 1 compression of value targets (reference
    planning/common/rewards.py:34-35)."""
    return torch.sqrt(value + 1.0) - 1.0


def invert_scaled_value_target(value: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`scale_value_target`: v² + 2v (reference
    planning/common/rewards.py:38-39)."""
    return torch.square(value) + 2.0 * value
