"""Two-branch regressor (port of crosstalk_tpu/models/two_branch.py), the
reference's ``SimplifiedTwoBranchRegressionModel`` (two_branch_regression.py:59-100).

Two weight-independent 4-block encoders (bleed on channel 0, source on
channel 1), each 1->f->2f->4f->8f; their maps concatenate on the channel
axis (bleed first) and feed a Dense(512) -> Dense(128) -> Dense(1) -> Sigmoid
head whose output is scaled by 0.5 into the alpha range [0, 0.5].
"""

from __future__ import annotations

import torch
from torch import nn

from crosstalk_tpu_torch.models.layers import ConvBlocks, conv_block, head_layers


class FeatureBranch(nn.Module):
    """4x ConvBlock encoder: 1 -> f -> 2f -> 4f -> 8f channels."""

    def __init__(self, filters: int, **kw):
        super().__init__()
        blocks = []
        cin = 1
        for mult in (1, 2, 4, 8):
            blocks += conv_block(cin, filters * mult, **kw)
            cin = filters * mult
        self.conv_blocks = ConvBlocks(*blocks)

    def _get_name(self) -> str:
        return "SimplifiedFeatureExtractionBranch"  # reference class name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_blocks(x)


class RegressionHead(nn.Module):
    def __init__(self, flat: int, dropout: float, **kw):
        super().__init__()
        self.fc_layers = nn.Sequential(
            *head_layers(flat, dropout, **kw), nn.Sigmoid())

    def _get_name(self) -> str:
        return "SimplifiedRegressionHead"  # reference class name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_layers(x)


class TwoBranchRegressor(nn.Module):
    def __init__(self, initial_filters_per_branch: int = 64,
                 image_size: int = 256, leaky_slope: float = 0.01,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 dropout: float = 0.5, device=None, process_group=None):
        super().__init__()
        kw = dict(slope=leaky_slope, eps=bn_eps, momentum=bn_momentum,
                  device=device, process_group=process_group)
        f = initial_filters_per_branch
        self.bleed_branch = FeatureBranch(f, **kw)
        self.source_branch = FeatureBranch(f, **kw)
        side = image_size >> 4
        self.regression_head = RegressionHead(
            2 * f * 8 * side * side, dropout, **kw)

    def _get_name(self) -> str:
        return "SimplifiedTwoBranchRegressionModel"  # reference class name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 2, H, W) float32 -> (B, 1) alpha in [0, 0.5]."""
        fused = torch.cat(
            [self.bleed_branch(x[:, 0:1]), self.source_branch(x[:, 1:2])], dim=1
        )
        return self.regression_head(fused) * 0.5
