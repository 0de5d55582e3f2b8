"""Reward and adaptive-mask ops (reference planning/common/rewards.py:8-31).

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
