"""Operations and bytes of the work the cells time, from shapes alone, and
the card's published peaks.

FLOPs count 2 per multiply-add of the 3x3 convolutions and the head's
dense layers (BatchNorm, activations and pools are not counted), as
``chip_smoke.py::conv_flops_per_tile`` does. A train step counts 3 x the
forward (the forward, and the backward's two products per layer).

Kernel K1 is the single-branch block 0 (conv3x3 2 -> 128 channels at full
resolution, folded BatchNorm, LeakyReLU, 2x2 max pool). Its least bytes
read the normalized float32 input tile and write the pooled bfloat16
output once each, plus the block's parameters once (bfloat16 weights and
the folded float32 scale and shift); whatever implements the block, this is
the layer's work.
"""

from __future__ import annotations

from benchmark.reference import model

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def forward_flops_per_tile(config: dict) -> int:
    convs, _ = model.branches(config)
    flops = 0
    for _, widths in convs:
        side = config["image_size"]
        for cin, cout in zip(widths, widths[1:]):
            flops += 2 * 9 * cin * cout * side * side
            side //= 2
    flat = model.flat_features(config)
    return flops + 2 * (flat * 512 + 512 * 128 + 128)


def train_flops_per_tile(config: dict) -> int:
    return 3 * forward_flops_per_tile(config)


def k1_shape(config: dict):
    """-> (input channels, output features) of block 0 as one K1 call (the
    two-branch model's two first blocks run as one block-diagonal call)."""
    convs, _ = model.branches(config)
    return 2, sum(widths[1] for _, widths in convs)


def k1_tile_bytes(config: dict, rows: int) -> int:
    c, f = k1_shape(config)
    side = config["image_size"]
    return rows * (side * side * c * 4 + (side // 2) ** 2 * f * 2)


def k1_param_bytes(config: dict) -> int:
    c, f = k1_shape(config)
    return 9 * c * f * 2 + 2 * f * 4


def k1_flops(config: dict, rows: int) -> int:
    c, f = k1_shape(config)
    side = config["image_size"]
    return rows * 2 * 9 * c * f * side * side


def k1_least_seconds(config: dict, rows: int) -> float:
    """The least time of one K1 call on ``rows`` tiles: the larger of its
    bytes over the HBM bandwidth and its FLOPs over the bf16 peak."""
    moved = k1_tile_bytes(config, rows) + k1_param_bytes(config)
    return max(moved / PEAK_HBM_BYTES_PER_S, k1_flops(config, rows) / PEAK_BF16_FLOPS)
