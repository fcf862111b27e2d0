"""Single-branch regressor (port of crosstalk_tpu/models/single_branch.py),
the reference's ``AdvancedRegressionModel`` (regression_model.py:5-61).

A 2-channel input runs through ``num_conv_blocks`` ConvBlocks whose widths
double per block capped at ``max_filters`` (2->128->256->512->512->512->512
at the instantiated config), then a Dense(512) -> Dense(128) -> Dense(1) head
with no output activation. NCHW; the head flattens (C, H, W).
"""

from __future__ import annotations

import torch
from torch import nn

from crosstalk_tpu_torch.models.layers import ConvBlocks, conv_block, head_layers


class SingleBranchRegressor(nn.Module):
    def __init__(self, input_channels: int = 2, initial_filters: int = 128,
                 num_conv_blocks: int = 6, max_filters: int = 512,
                 image_size: int = 256, leaky_slope: float = 0.01,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 dropout: float = 0.1, device=None, process_group=None):
        super().__init__()
        kw = dict(slope=leaky_slope, eps=bn_eps, momentum=bn_momentum,
                  device=device, process_group=process_group)
        layers = []
        cin, cout = input_channels, initial_filters
        layers += conv_block(cin, cout, **kw)
        for _ in range(1, num_conv_blocks):
            cin, cout = cout, min(cout * 2, max_filters)
            layers += conv_block(cin, cout, **kw)
        self.conv_layers = ConvBlocks(*layers)
        side = image_size >> num_conv_blocks
        self.fc_layers = nn.Sequential(
            *head_layers(cout * side * side, dropout, **kw))

    def _get_name(self) -> str:
        # the reference class name, which str(model) writes into
        # model_architecture.txt
        return "AdvancedRegressionModel"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 2, H, W) float32 -> (B, 1) alpha prediction."""
        return self.fc_layers(self.conv_layers(x))
