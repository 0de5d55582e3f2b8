"""Seeded network weights, made by the benchmark on the device in one
large draw and handed to the program and to the reference alike.

Every floating entry of the network's state dict gets a slice of one
standard-normal draw: kernels and dense weights scaled by 0.5/√fan-in
(so ten residual blocks keep the activations near unit scale), biases by
0.02, BatchNorm scales 1 + 0.1·u, shifts and running means 0.1·u,
running variances exp(0.2·u).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import inputs


def seeded(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    keys = [k for k, v in template.items() if v.is_floating_point()]
    total = sum(template[k].numel() for k in keys)
    u = torch.randn(total, generator=inputs.generator(seed, 7, device), device=device,
                    dtype=torch.float32)
    out, at = dict(template), 0
    for k in keys:
        t = template[k]
        x = u[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if k.endswith("running_var"):
            x = torch.exp(0.2 * x)
        elif k.endswith("running_mean"):
            x = 0.1 * x
        elif t.ndim >= 2:
            x = x * (0.5 / math.sqrt(t[0].numel()))
        elif ".BatchNorm_" in k and k.endswith(".weight"):
            x = 1.0 + 0.1 * x
        elif ".BatchNorm_" in k:
            x = 0.1 * x
        else:
            x = 0.02 * x
        out[k] = x.to(t.dtype).contiguous()
    return out
