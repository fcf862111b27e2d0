"""Fast inference path: the folded-BN bf16 eval forward (port of
crosstalk_tpu/eval/fast_forward.py).

In eval mode every ConvBlock is conv -> per-channel affine (BatchNorm's
running stats folded with the conv bias) -> LeakyReLU -> maxpool, and the
head is matmuls with the same folds (dropout inactive). ``make_fast_forward``
folds a state_dict once and returns ``forward(batch_nhwc) -> (B, 1)``:

  * block 0 (1-2 input channels) runs through the fused input-block kernel
    (ops/input_block.py, CUDA on the card); the two-branch model's pair of
    C=1 first blocks runs as ONE block-diagonal call of that kernel;
  * blocks 1+ are bf16 cuDNN convs in channels_last followed by the folded
    affine, LeakyReLU and pool as torch ops in bf16;
  * the head is bf16 matmuls whose products stay in f32, with the affine
    taken in f32 after the product.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple

import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.io.torch_convert import StateDict, count_blocks, structure
from crosstalk_tpu_torch.ops.input_block import (
    fold_bn_affine,
    fused_input_block_packed,
    pack_input_block,
)

_BF16 = torch.bfloat16


class _Conv(NamedTuple):
    weight: torch.Tensor  # (O, I, 3, 3) bf16, channels_last
    scale: torch.Tensor   # (1, O, 1, 1) bf16
    bias: torch.Tensor    # (1, O, 1, 1) bf16


class _Dense(NamedTuple):
    weight: torch.Tensor  # (out, in) bf16
    scale: torch.Tensor   # (out,) f32
    bias: torch.Tensor    # (out,) f32


def _block_affine(sd: StateDict, prefix: str, i: int, eps: float):
    """-> (HWIO f32 kernel, scale, bias) of block ``i`` under ``prefix``."""
    conv, bn = f"{prefix}.{4 * i}", f"{prefix}.{4 * i + 1}"
    scale, bias = fold_bn_affine(
        sd[f"{conv}.bias"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
        sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], eps,
    )
    return sd[f"{conv}.weight"].float().permute(2, 3, 1, 0), scale, bias


def _fold_conv(sd: StateDict, prefix: str, i: int, eps: float) -> _Conv:
    kernel, scale, bias = _block_affine(sd, prefix, i, eps)
    weight = kernel.permute(3, 2, 0, 1).to(_BF16).contiguous(
        memory_format=torch.channels_last)
    return _Conv(weight, scale.to(_BF16).view(1, -1, 1, 1),
                 bias.to(_BF16).view(1, -1, 1, 1))


def _fold_dense(sd: StateDict, head: str, lin: int, bn: int, eps: float,
                weight: torch.Tensor) -> _Dense:
    scale, bias = fold_bn_affine(
        sd[f"{head}.{lin}.bias"], sd[f"{head}.{bn}.weight"], sd[f"{head}.{bn}.bias"],
        sd[f"{head}.{bn}.running_mean"], sd[f"{head}.{bn}.running_var"], eps,
    )
    return _Dense(weight.to(_BF16).contiguous(), scale.float(), bias.float())


def _conv_block_eval(x: torch.Tensor, blk: _Conv, slope: float) -> torch.Tensor:
    """NCHW (channels_last) -> bf16 conv, affine, LeakyReLU, 2x2 max pool."""
    y = F.conv2d(x.to(_BF16), blk.weight, padding=1)
    y = F.leaky_relu(y * blk.scale + blk.bias, slope)
    return F.max_pool2d(y, 2)


def _matmul_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` of bf16 operands, kept in f32 as the JAX head does
    (``preferred_element_type=jnp.float32``): a cuBLAS bf16 GEMM with f32
    output on the card, the f32 product of the bf16 values on the CPU (each
    bf16 x bf16 product is exact in f32)."""
    x = x.to(_BF16)
    if x.is_cuda:
        return torch.mm(x, weight.t(), out_dtype=torch.float32)
    return torch.mm(x.float(), weight.float().t())


def _dense_bn_eval(x: torch.Tensor, d: _Dense, slope: float) -> torch.Tensor:
    y = _matmul_f32(x, d.weight) * d.scale + d.bias
    return F.leaky_relu(y, slope)


def _kernel_gate(x: torch.Tensor) -> bool:
    """Route block 0 through the fused kernel for C <= 4 and even H, W.

    These are the semantic conditions of the JAX gate (_pallas_gate,
    fast_forward.py:87). Its TPU-only lane (f_total % 128) and sublane
    (select_chunk(m) % 16) conditions are dropped: the CUDA kernel tiles by
    its own block shape and masks the ragged edges, so it has neither."""
    return x.shape[-1] <= 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0


def make_fast_forward(cfg: ModelConfig, state_dict: StateDict) -> Callable:
    """-> ``forward(batch_nhwc) -> (B, 1) float32`` predictions.

    The folded weights live on the state_dict's device; ``batch_nhwc`` is a
    normalized (B, H, W, 2) float32 batch on that device."""
    eps, slope, double = cfg.bn_eps, cfg.leaky_slope, cfg.variant == "double"
    sd = state_dict
    branches, head = structure(cfg.variant)
    prefixes = [p for p, _ in branches]
    n_blocks = count_blocks(sd, prefixes[0])

    # block 0 for the kernel: HWIO kernel and affine, packed once; for the
    # two-branch model, both branches' C=1 kernels stacked block-diagonally
    # into one C=2 -> 2F call (bleed reads channel 0 into [:F], source
    # channel 1 into [F:]), exactly the flagship single-branch kernel shape
    first = [_block_affine(sd, p, 0, eps) for p in prefixes]
    if double:
        (kb, sb, bb), (ks, ss, bs) = first
        f = kb.shape[-1]
        k0 = torch.zeros((3, 3, 2, 2 * f), dtype=kb.dtype, device=kb.device)
        k0[:, :, 0:1, :f] = kb
        k0[:, :, 1:2, f:] = ks
        first_packed = pack_input_block(k0, torch.cat([sb, ss]), torch.cat([bb, bs]))
    else:
        first_packed = pack_input_block(*first[0])
    convs: List[List[_Conv]] = [
        [_fold_conv(sd, p, i, eps) for i in range(n_blocks)] for p in prefixes
    ]

    # the torch head flattens NCHW as (C, H, W); the activations here are
    # channels_last, flattened as (H, W, C): permute the first head weight
    # once. C counts the concatenated bleed-then-source channels.
    w1 = sd[f"{head}.1.weight"]
    channels = sum(c[-1].weight.shape[0] for c in convs)
    side = math.isqrt(w1.shape[1] // channels)
    w1 = w1.reshape(w1.shape[0], channels, side, side).permute(0, 2, 3, 1)
    dense = [
        _fold_dense(sd, head, 1, 2, eps, w1.reshape(w1.shape[0], -1)),
        _fold_dense(sd, head, 5, 6, eps, sd[f"{head}.5.weight"]),
    ]
    w_out = sd[f"{head}.9.weight"].to(_BF16).contiguous()
    b_out = sd[f"{head}.9.bias"].float()

    def trunk(x_nchw: torch.Tensor, blocks: List[_Conv], start: int):
        for blk in blocks[start:]:
            x_nchw = _conv_block_eval(x_nchw, blk, slope)
        return x_nchw

    def forward(x: torch.Tensor) -> torch.Tensor:
        if _kernel_gate(x):
            z = fused_input_block_packed(x, first_packed, slope=slope).permute(0, 3, 1, 2)
            if double:
                f = z.shape[1] // 2
                feats = [z[:, :f], z[:, f:]]
            else:
                feats = [z]
            start = 1
        else:
            x_nchw = x.permute(0, 3, 1, 2)
            feats = [x_nchw[:, 0:1], x_nchw[:, 1:2]] if double else [x_nchw]
            start = 0
        h = torch.cat([
            trunk(a.contiguous(memory_format=torch.channels_last), blocks, start)
            for a, blocks in zip(feats, convs)
        ], dim=1)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        for d in dense:
            h = _dense_bn_eval(h, d, slope)
        out = _matmul_f32(h, w_out) + b_out
        if double:
            out = torch.sigmoid(out) * 0.5
        return out

    return forward
