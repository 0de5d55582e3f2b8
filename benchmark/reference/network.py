"""Plain reference of the MCTS-zero policy-value network and of its
input planes, in float64 with ``torch.nn.functional`` only.

The architecture is the reference's (ERFNet-style separable residual
encoder with global-context mixing, policy and value heads over global
avg‖max pooling): a 7×7 stride-2 stem, ten blocks (stride 2 at depths 0,
1, 3 and 5; a mixing block at depths 3, 6 and 9; one set of weights per
kind of block, shared across the depths of that kind), and heads of one
mixing block, two applications of one shared 3×3 conv-BN, pooling and a
dense layer.  BatchNorm runs on its running statistics (inference).
Weights come as a dict under the port's state-dict names, made by the
benchmark from the seed; nothing else of the program is read.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _bn(x, w, p, eps):
    return ((x - w[p + ".running_mean"][None, :, None, None])
            / torch.sqrt(w[p + ".running_var"][None, :, None, None] + eps)
            * w[p + ".weight"][None, :, None, None] + w[p + ".bias"][None, :, None, None])


def _conv(x, w, p, stride=1, padding=0, dilation=1):
    return F.conv2d(x, w[p + ".weight"], w.get(p + ".bias"), stride, padding, dilation)


def _pool(x):
    return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)


class RefNet:
    def __init__(self, weights: Dict[str, torch.Tensor], hp: Dict, dtype=torch.float64):
        self.w = {k: v.to(dtype) for k, v in weights.items() if v.is_floating_point()}
        self.hp = hp
        self.dtype = dtype
        self.g = int(hp.get("num_global_pooling_channels", 32))
        self.act = F.silu if hp.get("use_silu", True) else F.relu

    def _separable(self, x, p, down):
        w, act = self.w, self.act
        k = 0
        if down:
            x = act(_bn(_conv(x, w, f"{p}.Conv_0", stride=2), w, f"{p}.BatchNorm_0", 1e-5))
            k = 1
        x = _conv(x, w, f"{p}.Conv_{k}")
        b = 1 if down else 0
        out = act(_conv(x, w, f"{p}.Conv_{k + 1}", padding=(1, 0)))
        out = act(_bn(_conv(out, w, f"{p}.Conv_{k + 2}", padding=(0, 1)), w,
                      f"{p}.BatchNorm_{b}", 1e-3))
        out = act(_conv(out, w, f"{p}.Conv_{k + 3}", padding=(1, 0)))
        out = _bn(_conv(out, w, f"{p}.Conv_{k + 4}", padding=(0, 1)), w, f"{p}.BatchNorm_{b + 1}",
                  1e-3)
        return act(out + x)

    def _mix(self, x, p, stride):
        w, act, g = self.w, self.act, self.g
        if stride > 1:
            identity = _conv(x, w, f"{p}.Conv_0", stride=stride)
            out = _conv(x, w, f"{p}.Conv_1", stride=stride, padding=1)
        else:
            identity, out = x, _conv(x, w, f"{p}.Conv_0", padding=1)
        pool = _pool(act(_bn(out[:, :g], w, f"{p}.BatchNorm_0", 1e-5)))
        pool = act(F.linear(pool, w[f"{p}.Dense_0.weight"], w[f"{p}.Dense_0.bias"]))
        out = torch.cat([out[:, :g], out[:, g:] + pool[:, :, None, None]], dim=1)
        out = _bn(_conv(out, w, f"{p}.ConvBN_0.Conv_0", padding=1), w,
                  f"{p}.ConvBN_0.BatchNorm_0", 1e-5)
        return act(out + identity)

    def _head(self, x, p, blocks):
        w, act = self.w, self.act
        for i in range(blocks):
            if i == 0:
                x = self._mix(x, f"{p}.mix", 1)
            else:
                x = act(_bn(_conv(x, w, f"{p}.conv_block.Conv_0", padding=1), w,
                            f"{p}.conv_block.BatchNorm_0", 1e-5))
        return F.linear(_pool(x), w[f"{p}.head.weight"], w[f"{p}.head.bias"])

    def __call__(self, planes: torch.Tensor, mask: torch.Tensor):
        """planes (S, C, N, N), mask (S, A) → (policy probabilities (S, A),
        value on its true scale (S,))."""
        hp, w, act = self.hp, self.w, self.act
        x = planes.to(self.dtype)
        x = act(_bn(_conv(x, w, "encoder.stem.Conv_0", stride=2, padding=3), w,
                    "encoder.stem.BatchNorm_0", 1e-5))
        for i in range(int(hp["num_encoder_res_blocks"])):
            stride = 2 if i in (0, 1, 3, 5) else 1
            if i > 0 and i % 3 == 0:
                x = self._mix(x, f"encoder.mix_s{stride}", stride)
            else:
                x = self._separable(x, f"encoder.block_s{stride}", stride == 2)
        logits = self._head(x, "policy_head", int(hp.get("num_policy_head_conv_bn_blocks", 3)))
        logits = logits - (1.0 - mask.to(logits.dtype)) * 1000.0
        policy = torch.softmax(logits, dim=-1)
        z = self._head(x, "value_head", int(hp.get("num_value_head_conv_bn_blocks", 3)))
        if not hp.get("unfloored_value_head", False):
            z = act(z)
        v = torch.logaddexp(z, torch.zeros_like(z))[:, 0]
        return policy, v * v + 2.0 * v


def _minmax(x):
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    same = hi == lo
    safe = torch.where(same & (hi == 0), torch.ones_like(hi), hi)
    return torch.where(same, x / safe, (x - lo) / torch.where(same, torch.ones_like(hi), hi - lo))


def planes(world, covs, positions, budgets, length, mean, dtype=torch.float64):
    """(S, 5·L + 1, N, N) input planes of leaves whose history (most recent
    first) is covs (S, L, N, N), positions (S, L, 3), budget fractions
    (S, L), valid entries ``length`` (S,), with the root's mean (S, N): per
    entry the covariance restricted to the region of interest and min-max
    normalised, x / extent, y / extent, the altitude's share of the band
    and the budget fraction (zero past ``length``); last, row i the flight
    time from the newest position to cell i, both at the lowest altitude,
    min-max normalised."""
    covs, positions = covs.to(dtype), positions.to(dtype)
    budgets, mean = budgets.to(dtype), mean.to(dtype)
    S, L, n, _ = covs.shape
    valid = (torch.arange(L, device=covs.device) < length[:, None]).to(dtype)
    if world.adaptive:
        diag = torch.diagonal(covs, dim1=-2, dim2=-1)
        m = (mean[:, None, :] + world.interval * diag >= world.threshold).to(dtype)
        covs = covs * m[..., :, None] * m[..., None, :]
    st = _minmax(covs)
    ones = torch.ones((S, L, n, n), dtype=dtype, device=covs.device)
    per = [st,
           positions[..., 0, None, None] / (world.x_dim * world.res) * ones,
           positions[..., 1, None, None] / (world.y_dim * world.res) * ones,
           (positions[..., 2, None, None] - world.min_alt) / (world.max_alt - world.min_alt) * ones,
           budgets[..., None, None] * ones]
    steps = torch.stack(per, dim=2) * valid[:, :, None, None, None]  # (S, L, 5, n, n)
    cur = positions[:, 0].clone()
    cur[:, 2] = world.min_alt
    cells = world.xyz[:n].clone().to(dtype)
    cells[:, 2] = world.min_alt
    cost = world.flight_time(cells[None], cur[:, None]).to(dtype)  # (S, n)
    cost = _minmax(cost[:, None, :])[:, 0]
    last = cost[:, :, None].expand(S, n, n)
    return torch.cat([steps.reshape(S, L * 5, n, n), last[:, None]], dim=1)
