"""Carry state from the JAX package (or any numpy source) into the port.

What crosses:

  * a ``BeliefState`` given as arrays (mean, cov, pos, budget,
    ground_truth, active, step), either as a mapping or as any object
    with those attributes (the JAX package's ``BeliefState`` qualifies —
    this module imports nothing from it);
  * random draws: per-step measurement noise (T, B, M), and the
    baselines' and CMA-ES's draws (``draws_from_arrays``);
  * the policy-value network's weights: a flax variable tree (nested
    dicts of numpy arrays, as ``serialization.read_checkpoint`` or flax
    itself gives it) becomes the port's ``state_dict``, and back
    (``flax_variables``, for the checkpoints the port writes).

They land on the port's device in the port's dtype, so the two packages
compute the same thing from the same draws and weights
(tests/test_torch_greedy.py, tests/test_torch_zero_*.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

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


def draws_from_arrays(
    draws: Any, shape: Sequence[Optional[int]], device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Random draws made on the JAX side, on the port's device in
    ``dtype``, checked against ``shape`` (None: an axis of any length).
    The draws the planners take:

      * measurement noise (T, B, M) (``noise_from_arrays``);
      * the random continuous baseline's uniforms (B, T, 3);
      * the random discrete baseline's Gumbel draws (T, B, A);
      * CMA-ES's normals (T, B, generations, λ, D) for ``run``, one step's
        (B, generations, λ, D) for ``replan_batch``."""
    arr = np.array(draws)
    if arr.ndim != len(shape) or any(n is not None and n != m for n, m in zip(shape, arr.shape)):
        raise ValueError(f"draws must have shape {tuple(shape)} (None: any length), "
                         f"got {arr.shape}")
    return torch.as_tensor(arr, device=resolve_device(device)).to(dtype)


def noise_from_arrays(
    noise: Any, device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(T, B, M) per-step measurement noise on the port's device."""
    return draws_from_arrays(noise, (None, None, None), device, dtype)


def _leaf(module: str, name: str, value: np.ndarray) -> tuple:
    """(torch name, array) of one flax leaf of module ``module``."""
    if name == "kernel" and value.ndim == 4:
        if module.startswith("ConvTranspose_"):
            # flax's transposed conv is torch's with a flipped kernel
            return "weight", np.flip(value, (0, 1)).transpose(2, 3, 0, 1)
        return "weight", value.transpose(3, 2, 0, 1)  # HWIO → OIHW
    if name == "kernel" and value.ndim == 2:
        return "weight", value.T  # Dense (in, out) → Linear (out, in)
    renamed = {"bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    if name not in renamed:
        raise KeyError(f"unknown flax leaf {module}/{name} {value.shape}")
    return renamed[name], value


def network_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax variable tree
    ``{"params": ..., "batch_stats": ...}`` of one network.

    The port's modules carry flax's names (models/layers.py), so a module
    path maps as it stands: Conv kernels HWIO → OIHW, Dense kernels
    (in, out) → (out, in), BatchNorm scale/bias/mean/var →
    weight/bias/running_mean/running_var (with ``num_batches_tracked`` 0,
    torch's own counter).  A leaf of unknown kind raises here; a leaf the
    network lacks, or a weight the tree lacks, raises in
    ``load_state_dict`` (strict)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            name, array = _leaf(path[-1], key, np.asarray(value))
            full = ".".join(path + (name,))
            if full in out:
                raise KeyError(f"two flax leaves map to {full}")
            out[full] = torch.from_numpy(np.array(array, order="C"))  # a writable copy
            if name == "running_mean":
                out[".".join(path + ("num_batches_tracked",))] = torch.tensor(0)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def flax_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax variable tree ``{"params": ..., "batch_stats": ...}`` (nested
    dicts of C-ordered numpy arrays) of one network's ``state_dict``: the
    inverse of :func:`network_state_dict`.  Conv weights OIHW → HWIO (a
    transposed conv's also flipped in both spatial axes), Linear (out, in)
    → Dense (in, out), BatchNorm weight/bias/running_mean/running_var →
    scale/bias/mean/var; ``num_batches_tracked`` is dropped."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for full, tensor in state_dict.items():
        *path, name = full.split(".")
        if name == "num_batches_tracked":
            continue
        value = tensor.detach().cpu().numpy()
        collection = "params"
        if name == "weight" and value.ndim == 4:
            if path[-1].startswith("ConvTranspose_"):
                name, value = "kernel", np.flip(value.transpose(2, 3, 0, 1), (0, 1))
            else:
                name, value = "kernel", value.transpose(2, 3, 1, 0)  # OIHW → HWIO
        elif name == "weight" and value.ndim == 2:
            name, value = "kernel", value.T
        elif name == "weight" and value.ndim == 1:
            name = "scale"
        elif name in ("running_mean", "running_var"):
            collection, name = "batch_stats", name[len("running_"):]
        elif name != "bias":
            raise KeyError(f"unknown state_dict entry {full} {tuple(value.shape)}")
        node = out[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(value)
    return out
