"""The policy-value network's inference side.

Port of the inference half of ``ipp_rl_tpu/planners/zero/train.py``:
``predict_fn`` (:233-269), ``split_predict_fn`` (:402-426),
``inference_dtype`` (:429-431), and ``init_network`` in place of the
network construction in ``init_train_state``.  The optimiser, the losses
and the train step belong to the training slice.

A predict function has the JAX package's interface,
``predict(variables, planes, valid_mask) -> (policy, value)``: the
weights are passed in as a ``state_dict`` (``torch.func.functional_call``,
the counterpart of ``net.apply``), so a caller can swap or cast weights
without rebuilding the module.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ipp_rl_tpu_torch.config.schema import Config, MCTSZeroHyperParams
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.models.networks import PolicyNetwork, PolicyValueNetwork, ValueNetwork
from ipp_rl_tpu_torch.ops.rewards import invert_scaled_value_target

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by this factor to keep the variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``net``'s weights as flax initialises its modules: kernels
    lecun-normal, biases 0, BatchNorm scale 1, bias 0, mean 0, var 1."""
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # (out, in, ...)
                fan_in = w[0].numel()
            _lecun_normal_(w, fan_in, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return net


def init_network(
    cfg: Config,
    hp: MCTSZeroHyperParams,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> PolicyValueNetwork:
    """A ``PolicyValueNetwork`` on ``device`` in inference mode, its weights
    drawn from ``generator`` (a generator on that device) as flax draws
    them."""
    dev = resolve_device(device)
    net = PolicyValueNetwork(hp, cfg.num_actions).to(device=dev, dtype=dtype).eval()
    return flax_init_(net, generator)


def cast_variables(variables, dtype: torch.dtype):
    """Floating tensors of a (nested) state dict cast to ``dtype``."""
    if isinstance(variables, dict):
        return {k: cast_variables(v, dtype) for k, v in variables.items()}
    return variables.to(dtype) if variables.is_floating_point() else variables


def _compute_variables(variables: Dict[str, torch.Tensor], dtype: torch.dtype):
    """The weights in the computation's dtype.  flax promotes float32
    weights to the planes' dtype (float64 in the tests); torch does not,
    so the weights are cast where they differ."""
    if all(not v.is_floating_point() or v.dtype == dtype for v in variables.values()):
        return variables
    return cast_variables(variables, dtype)


def _outputs(log_policy: torch.Tensor, value: torch.Tensor):
    # the value head emits √-scaled values; outputs come back as float32
    return torch.exp(log_policy.float()), invert_scaled_value_target(value.float())


def predict_fn(net: PolicyValueNetwork, dtype: Optional[torch.dtype] = None):
    """Inference: (variables, planes (B, S, S, C), mask (B, A)) → (policy
    probabilities (B, A), value (B,)), both float32, the value on its true
    scale (v² + 2v; reference wrappers :217-231).

    ``dtype=torch.bfloat16`` runs the forward in bf16.  The function
    carries ``infer_dtype`` so the search casts its weights once before the
    simulation loop (the cast here is then an identity) and builds the
    leaf planes at that width."""

    def predict(variables, planes, valid_mask):
        dt = dtype or planes.dtype
        planes = planes.to(dt)
        with torch.no_grad():
            log_policy, value, _, _ = functional_call(
                net, _compute_variables(variables, dt), (planes, valid_mask)
            )
        return _outputs(log_policy, value)

    predict.infer_dtype = dtype
    return predict


def split_predict_fn(nets: Tuple[PolicyNetwork, ValueNetwork], dtype: Optional[torch.dtype] = None):
    """:func:`predict_fn` over the split networks, with
    ``variables = {"policy": ..., "value": ...}``."""
    p_net, v_net = nets

    def predict(variables, planes, valid_mask):
        dt = dtype or planes.dtype
        planes = planes.to(dt)
        with torch.no_grad():
            log_policy = functional_call(
                p_net, _compute_variables(variables["policy"], dt), (planes, valid_mask)
            )
            value, _ = functional_call(v_net, _compute_variables(variables["value"], dt), (planes,))
        return _outputs(log_policy, value)

    predict.infer_dtype = dtype
    return predict


def inference_dtype(hp: MCTSZeroHyperParams) -> Optional[torch.dtype]:
    """hp.inference_dtype as the dtype for :func:`predict_fn` (None = the
    planes' own)."""
    return torch.bfloat16 if hp.inference_dtype == "bfloat16" else None
