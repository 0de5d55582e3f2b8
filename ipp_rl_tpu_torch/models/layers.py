"""Building blocks of the policy-value CNN (NCHW).

Port of ``ipp_rl_tpu/models/layers.py`` (flax, NHWC).  What the flax
modules leave to defaults is spelled out here:

  * ``nn.Conv`` has a bias unless told otherwise, and "SAME" padding,
    which is padding 0 for the 1×1 convolutions that rely on it (the
    ``use_1x1conv`` projection, the stride-2 downsample, the mixing
    block's stride-2 identity); every larger kernel has explicit padding;
  * no bias on ``ConvBN``'s convolution, the downsample convolution and
    the mixing block's 3×3 convolution;
  * BatchNorm eps 1e-5, except 1e-3 in ``NonBottleneck1d``'s two norms;
    momentum (flax's sense: the running statistics' share) 0.9 in
    ``ConvBN``, flax's default 0.99 in every other norm;
  * ``GlobalPooling`` concatenates the mean, then the max.

Submodules carry flax's names (``Conv_0``, ``BatchNorm_1``, ``Dense_0``,
``ConvBN_0``, numbered per kind in the order flax creates them, or the
name a flax ``setup`` gives), so a flax variable tree maps one to one onto
the state dict (convert.network_state_dict).  A block that flax would
never call, and so never give parameters, is not created.

Every block's ``forward`` takes ``train`` (False: inference) and a
``generator``.  In training mode BatchNorm normalises with the batch's
statistics and blends them into its running statistics as flax does
(with the *biased* batch variance), and dropout draws its mask
from ``generator`` (flax: ``bernoulli(keep)``, kept entries divided by
``keep``).  ``ResidualBlock``, ``NonBottleneck1d`` and ``MixGlobalContext``
carry the dropout, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def nonlinearity_fn(use_silu: bool) -> Callable:
    return F.silu if use_silu else F.relu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as jax.nn.softplus computes it (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers (so state dicts keep
    their names), with flax's training update.  ``train=False`` uses the
    running statistics; ``train=True`` normalises with the batch's and
    then sets ``running = m·running + (1 − m)·batch`` with the biased batch
    variance, as flax's ``BatchNorm(momentum=m)`` does.  torch's own
    update would blend in the unbiased variance, so it is not used;
    ``num_batches_tracked`` stays as it was (flax keeps no count)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = (0, 2, 3)
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * x.mean(dim=dims))
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * x.var(dim=dims, unbiased=False))
        return out


def batch_norm(features: int, eps: float = 1e-5, momentum: float = 0.99) -> BatchNorm:
    """flax's ``nn.BatchNorm`` defaults: eps 1e-5, momentum 0.99."""
    return BatchNorm(features, eps, momentum)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: the identity unless training with rate > 0;
    then each entry is kept with probability 1 − rate (a uniform draw from
    ``generator`` below it) and scaled by 1 / (1 − rate)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm (reference layers.py:5-8)."""

    def __init__(self, in_features: int, features: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: int = 0, bn_eps: float = 1e-5):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride, padding, bias=False)
        self.BatchNorm_0 = batch_norm(features, bn_eps, momentum=0.9)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x), train)


class GlobalPooling(nn.Module):
    """Global avg‖max pooling (B, C, H, W) → (B, 2C) (reference
    layers.py:151-161)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)


class ResidualBlock(nn.Module):
    """Plain 3×3 residual block (reference layers.py:11-37)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_silu: bool = True, use_1x1conv: bool = False, dropout: float = 0.0):
        super().__init__()
        self.act = nonlinearity_fn(use_silu)
        self.use_1x1conv, self.dropout = use_1x1conv, dropout
        if use_1x1conv:
            self.Conv_0 = nn.Conv2d(in_features, features, 1, stride)
        self.ConvBN_0 = ConvBN(in_features, features, (3, 3), stride, 1)
        self.ConvBN_1 = ConvBN(features, features, (3, 3), 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        identity = self.Conv_0(x) if self.use_1x1conv else x
        out = self.ConvBN_1(self.act(self.ConvBN_0(x, train)), train)
        out = dropout(out, self.dropout, train, generator)
        return self.act(out + identity)


class NonBottleneck1d(nn.Module):
    """Separable factorised 3×1/1×3 residual block, ERFNet-style
    (reference layers.py:40-100).  flax numbers the convolutions from the
    optional downsample on: downsample, 1×1 projection, then the four
    separable convolutions."""

    def __init__(self, in_features: int, features: int, dilated: int = 1,
                 use_silu: bool = True, use_1x1conv: bool = False,
                 down_sample: bool = False, dropout: float = 0.0):
        super().__init__()
        self.act = nonlinearity_fn(use_silu)
        self.down_sample, self.use_1x1conv = down_sample, use_1x1conv
        self.dropout = dropout
        f, d = features, dilated
        convs = []
        if down_sample:
            convs.append(nn.Conv2d(in_features, f, 1, 2, bias=False))
            in_features = f
        if use_1x1conv:
            convs.append(nn.Conv2d(in_features, f, 1))
        convs += [
            nn.Conv2d(f, f, (3, 1), padding=(1, 0)),
            nn.Conv2d(f, f, (1, 3), padding=(0, 1)),
            nn.Conv2d(f, f, (3, 1), padding=(d, 0), dilation=(d, 1)),
            nn.Conv2d(f, f, (1, 3), padding=(0, d), dilation=(1, d)),
        ]
        for k, conv in enumerate(convs):
            self.add_module(f"Conv_{k}", conv)
        norms = ([batch_norm(f)] if down_sample else []) + [batch_norm(f, 1e-3) for _ in range(2)]
        for k, norm in enumerate(norms):
            self.add_module(f"BatchNorm_{k}", norm)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act = self.act
        conv = iter(getattr(self, f"Conv_{k}") for k in range(6))
        norm = iter(getattr(self, f"BatchNorm_{k}") for k in range(3))
        if self.down_sample:
            x = act(next(norm)(next(conv)(x), train))
        if self.use_1x1conv:
            x = next(conv)(x)
        out = act(next(conv)(x))
        out = act(next(norm)(next(conv)(out), train))
        out = act(next(conv)(out))
        out = next(norm)(next(conv)(out), train)
        out = dropout(out, self.dropout, train, generator)
        return act(out + x)


class MixGlobalContext(nn.Module):
    """Global-context mixing block (reference layers.py:103-148): pooled
    statistics of the first G channels are broadcast-added into the other
    C − G channels (into channels G: only)."""

    def __init__(self, in_features: int, features: int,
                 num_global_pooling_channels: int = 32, stride: int = 1,
                 use_silu: bool = True, dropout: float = 0.0):
        super().__init__()
        g = num_global_pooling_channels
        if g >= features:
            raise ValueError(
                f"num_global_pooling_channels ({g}) must be < num_channels ({features})"
            )
        self.act = nonlinearity_fn(use_silu)
        self.g, self.stride, self.dropout = g, stride, dropout
        convs = []
        if stride > 1:  # the identity: 1×1, strided, with a bias
            convs.append(nn.Conv2d(in_features, features, 1, stride))
        convs.append(nn.Conv2d(in_features, features, 3, stride, 1, bias=False))
        for k, conv in enumerate(convs):
            self.add_module(f"Conv_{k}", conv)
        self.BatchNorm_0 = batch_norm(g)
        self.pool = GlobalPooling()
        self.Dense_0 = nn.Linear(2 * g, features - g)
        self.ConvBN_0 = ConvBN(features, features, (3, 3), 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act, g = self.act, self.g
        if self.stride > 1:
            identity, out = self.Conv_0(x), self.Conv_1(x)
        else:
            identity, out = x, self.Conv_0(x)
        pool = self.pool(act(self.BatchNorm_0(out[:, :g], train)))  # (B, 2G)
        pool = act(self.Dense_0(pool))
        out = torch.cat([out[:, :g], out[:, g:] + pool[:, :, None, None]], dim=1)
        out = self.ConvBN_0(out, train)
        out = dropout(out, self.dropout, train, generator)
        return act(out + identity)


def encoder_plan(num_res_blocks: int, use_global_context: bool):
    """The block kind at each depth: stride 2 at i ∈ {0, 1, 3, 5}, and a
    mixing block in place of every i > 0 with i % 3 == 0 (reference
    layers.py:164-223)."""
    plan = []
    for i in range(num_res_blocks):
        stride = 2 if i in (0, 1, 3, 5) else 1
        mix = i > 0 and i % 3 == 0 and use_global_context
        plan.append(f"{'mix' if mix else 'block'}_s{stride}")
    return plan


class Encoder(nn.Module):
    """7×7 stride-2 stem + residual blocks.  One instance per (kind,
    stride), called at every depth of its kind: the weights are shared
    across those depths, as in the reference and the JAX package."""

    def __init__(self, input_channels: int, features: int, num_res_blocks: int,
                 use_silu: bool = True, use_separable: bool = True,
                 use_global_context: bool = True, num_global_pooling_channels: int = 32,
                 dropout: float = 0.0):
        super().__init__()
        self.act = nonlinearity_fn(use_silu)
        f = features
        self.stem = ConvBN(input_channels, f, (7, 7), 2, 3)
        self.plan = encoder_plan(num_res_blocks, use_global_context)
        for kind in dict.fromkeys(self.plan):
            stride = int(kind[-1])
            if kind.startswith("mix"):
                block = MixGlobalContext(f, f, num_global_pooling_channels, stride, use_silu,
                                         dropout)
            elif use_separable:
                block = NonBottleneck1d(f, f, 1, use_silu, use_1x1conv=True,
                                        down_sample=stride == 2, dropout=dropout)
            else:
                block = ResidualBlock(f, f, stride, use_silu, use_1x1conv=True, dropout=dropout)
            self.add_module(kind, block)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.act(self.stem(x, train))
        for kind in self.plan:
            x = getattr(self, kind)(x, train, generator)
        return x


class Decoder(nn.Module):
    """Transposed-conv reconstruction head (reference layers.py:226-252).
    flax's ``ConvTranspose`` (SAME, kernel not transposed) is torch's with
    the kernel flipped in both spatial axes (convert.network_state_dict)."""

    def __init__(self, features: int, use_silu: bool = True):
        super().__init__()
        self.act = nonlinearity_fn(use_silu)
        c = features
        self.ConvTranspose_0 = nn.ConvTranspose2d(c, c // 2, 2, 2)
        self.BatchNorm_0 = batch_norm(c // 2)
        self.ConvBN_0 = ConvBN(c // 2, c // 4, (3, 3), 1, 1)
        self.ConvTranspose_1 = nn.ConvTranspose2d(c // 4, c // 8, 2, 2)
        self.BatchNorm_1 = batch_norm(c // 8)
        self.ConvBN_1 = ConvBN(c // 8, 1, (3, 3), 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        act = self.act
        x = act(self.BatchNorm_0(self.ConvTranspose_0(x), train))
        x = act(self.ConvBN_0(x, train))
        x = act(self.BatchNorm_1(self.ConvTranspose_1(x), train))
        return self.ConvBN_1(x, train)[:, 0]


class _Head(nn.Module):
    """The heads' trunk: the mixing block at i = 0 (with global context),
    then one shared ConvBN block for every other depth, then global
    pooling."""

    def __init__(self, features: int, num_blocks: int, out_features: int,
                 use_silu: bool, use_global_context: bool, num_global_pooling_channels: int,
                 dropout: float):
        super().__init__()
        self.act = nonlinearity_fn(use_silu)
        self.plan = ["mix" if i == 0 and use_global_context else "conv_block"
                     for i in range(num_blocks)]
        if "mix" in self.plan:
            self.mix = MixGlobalContext(features, features, num_global_pooling_channels, 1,
                                        use_silu, dropout)
        if "conv_block" in self.plan:
            self.conv_block = ConvBN(features, features, (3, 3), 1, 1)
        self.pool = GlobalPooling()
        self.head = nn.Linear(2 * features, out_features)

    def trunk(self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
        for kind in self.plan:
            if kind == "mix":
                x = self.mix(x, train, generator)
            else:
                x = self.act(self.conv_block(x, train))
        return self.pool(x)


class ValueHead(_Head):
    """Convs → global pool → Linear(2C, 1) → act → softplus (reference
    layers.py:255-298).  ``unfloored`` drops the activation before the
    softplus (the JAX package's documented deviation, which the committed
    checkpoint needs)."""

    def __init__(self, features: int, num_blocks: int, use_silu: bool = True,
                 use_reward_target: bool = False, use_global_context: bool = True,
                 num_global_pooling_channels: int = 32, unfloored: bool = False,
                 dropout: float = 0.0):
        super().__init__(features, num_blocks, 1, use_silu, use_global_context,
                         num_global_pooling_channels, dropout)
        self.use_reward_target, self.unfloored = use_reward_target, unfloored

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        z = self.head(self.trunk(x, train, generator))
        if not self.unfloored:
            z = self.act(z)
        value = softplus(z)[:, 0]
        # the reference's reward output reuses the value head's layer
        return value, (value if self.use_reward_target else None)


class PolicyHead(_Head):
    """Convs → global pool → Linear(2C, A) → invalid-logit −1000 mask →
    log-softmax (reference layers.py:301-346)."""

    def __init__(self, features: int, num_blocks: int, num_actions: int,
                 use_silu: bool = True, mask_policy: bool = True,
                 use_global_context: bool = True, num_global_pooling_channels: int = 32,
                 dropout: float = 0.0):
        super().__init__(features, num_blocks, num_actions, use_silu, use_global_context,
                         num_global_pooling_channels, dropout)
        self.mask_policy = mask_policy

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        logits = self.head(self.trunk(x, train, generator))
        if self.mask_policy:
            logits = logits - (1.0 - valid_mask.to(logits.dtype)) * 1000.0
        return torch.log_softmax(logits, dim=-1)
