"""Policy-value networks (reference planning/mcts_zero/networks/).

Port of ``ipp_rl_tpu/models/networks.py``.  ``PolicyValueNetwork`` is the
shared encoder → policy head + value head (+ optional decoder); the split
``PolicyNetwork`` and ``ValueNetwork`` mirror the JAX package's, whose
flax-compact submodules are named ``Encoder_0`` and ``PolicyHead_0`` /
``ValueHead_0``.

Inputs are the feature planes in the JAX package's NHWC layout
(B, S, S, C), S = num_grid_cells; they are permuted to NCHW once, at the
network's input (a free view when the planes were built NCHW, as
planners/zero/features.feature_planes builds them).

``train=True`` runs every block in training mode (models/layers.py: batch
statistics, dropout of rate ``hp.dropout`` drawn from ``generator``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ipp_rl_tpu_torch.config.schema import Config, MCTSZeroHyperParams
from ipp_rl_tpu_torch.models.layers import Decoder, Encoder, PolicyHead, ValueHead


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def plane_channels(hp: MCTSZeroHyperParams) -> int:
    """Channels of the feature planes (planners/zero/features.py): 5 (3 with
    FoV planes) per history step, plus the action-cost plane.  flax infers
    the stem's input width from the planes; torch is given this count."""
    per_step = 3 if hp.use_fov_input else 5
    return per_step * hp.input_history_length + int(hp.use_action_costs_input)


def _encoder(hp: MCTSZeroHyperParams) -> Encoder:
    return Encoder(
        input_channels=plane_channels(hp),
        features=hp.num_channels,
        num_res_blocks=hp.num_encoder_res_blocks,
        use_silu=hp.use_silu,
        use_separable=hp.use_separable_conv_layers,
        use_global_context=hp.use_global_context_mixing,
        num_global_pooling_channels=hp.num_global_pooling_channels,
        dropout=hp.dropout,
    )


def _policy_head(hp: MCTSZeroHyperParams, num_actions: int) -> PolicyHead:
    return PolicyHead(
        features=hp.num_channels,
        num_blocks=hp.num_policy_head_conv_bn_blocks,
        num_actions=num_actions,
        use_silu=hp.use_silu,
        mask_policy=hp.mask_policy_head,
        use_global_context=hp.use_global_context_mixing,
        num_global_pooling_channels=hp.num_global_pooling_channels,
        dropout=hp.dropout,
    )


def _value_head(hp: MCTSZeroHyperParams) -> ValueHead:
    return ValueHead(
        features=hp.num_channels,
        num_blocks=hp.num_value_head_conv_bn_blocks,
        use_silu=hp.use_silu,
        use_reward_target=hp.use_reward_target,
        use_global_context=hp.use_global_context_mixing,
        num_global_pooling_channels=hp.num_global_pooling_channels,
        unfloored=hp.unfloored_value_head,
        dropout=hp.dropout,
    )


class PolicyValueNetwork(nn.Module):
    """Shared encoder → policy head + value head (+ decoder), the reference
    composition (reference networks/policy_value_networks.py:12-69)."""

    def __init__(self, hp: MCTSZeroHyperParams, num_actions: int):
        super().__init__()
        self.hp = hp
        self.encoder = _encoder(hp)
        self.policy_head = _policy_head(hp, num_actions)
        self.value_head = _value_head(hp)
        if hp.use_autoencoder:
            self.decoder = Decoder(hp.num_channels, use_silu=hp.use_silu)

    def forward(
        self, x: torch.Tensor, valid_mask: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """x: (B, S, S, C) planes; valid_mask: (B, A).  Returns (log_policy
        (B, A), value (B,), reward (B,) | None, reconstruction (B, h, w) |
        None)."""
        feat = self.encoder(_nchw(x), train, generator)
        log_policy = self.policy_head(feat, valid_mask, train, generator)
        value, reward = self.value_head(feat, train, generator)
        recon = self.decoder(feat, train) if self.hp.use_autoencoder else None
        return log_policy, value, reward, recon


class PolicyNetwork(nn.Module):
    """Split policy-only net (reference networks/policy_networks.py:12-58)."""

    def __init__(self, hp: MCTSZeroHyperParams, num_actions: int):
        super().__init__()
        self.Encoder_0 = _encoder(hp)
        self.PolicyHead_0 = _policy_head(hp, num_actions)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.Encoder_0(_nchw(x), train, generator)
        return self.PolicyHead_0(feat, valid_mask, train, generator)


class ValueNetwork(nn.Module):
    """Split value-only net (reference networks/value_networks.py:12-53)."""

    def __init__(self, hp: MCTSZeroHyperParams):
        super().__init__()
        self.Encoder_0 = _encoder(hp)
        self.ValueHead_0 = _value_head(hp)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.ValueHead_0(self.Encoder_0(_nchw(x), train, generator), train, generator)


def build_network(cfg: Config, hp: MCTSZeroHyperParams) -> PolicyValueNetwork:
    return PolicyValueNetwork(hp, cfg.num_actions)
