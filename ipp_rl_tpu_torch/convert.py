"""Carry state from the JAX package (or any numpy source) into the port.

The greedy slice has no network weights; what crosses is the mission
state and the measurement noise:

  * a ``BeliefState`` given as arrays (mean, cov, pos, budget,
    ground_truth, active, step), either as a mapping or as any object
    with those attributes (the JAX package's ``BeliefState`` qualifies —
    this module imports nothing from it);
  * per-step measurement noise (T, B, M).

Both land on the port's device in the port's dtype, so the two packages
compute the same thing from the same draws (tests/test_torch_greedy.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.env.world import BeliefState

_FIELDS = ("mean", "cov", "pos", "budget", "ground_truth", "active", "step")


def belief_state_from_arrays(
    src: Any, device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32
) -> BeliefState:
    """A port ``BeliefState`` from array-likes (floats in ``dtype``,
    ``active`` as bool, ``step`` as int32)."""
    dev = resolve_device(device)

    def get(name):
        value = src[name] if isinstance(src, dict) else getattr(src, name)
        return np.array(value)

    def to(name, dt):
        return torch.as_tensor(get(name), device=dev).to(dt)

    missing = [f for f in _FIELDS if not (f in src if isinstance(src, dict) else hasattr(src, f))]
    if missing:
        raise KeyError(f"belief state lacks {missing}")
    return BeliefState(
        mean=to("mean", dtype),
        cov=to("cov", dtype),
        pos=to("pos", dtype),
        budget=to("budget", dtype),
        ground_truth=to("ground_truth", dtype),
        active=to("active", torch.bool),
        step=to("step", torch.int32),
    )


def noise_from_arrays(
    noise: Any, device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(T, B, M) per-step measurement noise on the port's device."""
    arr = np.array(noise)
    if arr.ndim != 3:
        raise ValueError(f"noise must be (T, B, M), got shape {arr.shape}")
    return torch.as_tensor(arr, device=resolve_device(device)).to(dtype)
