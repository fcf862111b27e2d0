"""Fast inference path: the folded-BN bf16 eval forward (port of
crosstalk_tpu/eval/fast_forward.py).

In eval mode every ConvBlock is conv -> per-channel affine (BatchNorm's
running stats folded with the conv bias) -> LeakyReLU -> maxpool, and the
head is matmuls with the same folds (dropout inactive). ``make_fast_forward``
folds a state_dict once and returns ``forward(batch_nhwc) -> (B, 1)``:

  * block 0 (1-2 input channels) runs through the fused input-block kernel
    (ops/input_block.py, CUDA on the card); the two-branch model's pair of
    C=1 first blocks runs as ONE block-diagonal call of that kernel
    (``make_first_block``, which the int8 tier shares);
  * blocks 1+ are bf16 cuDNN convs in channels_last followed by the folded
    affine, LeakyReLU and pool as torch ops in bf16;
  * the head is bf16 matmuls whose products stay in f32, with the affine
    taken in f32 after the product.
"""

from __future__ import annotations

import math
import struct
from typing import Callable, List, NamedTuple

import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.config import ModelConfig, require_cnn
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


def bf16_value(v: float) -> float:
    """``v`` rounded to the nearest bf16, ties to even: the JAX epilogues'
    ``jnp.asarray(slope, bf16)``. In plain Python, so that an export trace
    sees a constant."""
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _conv_block_eval(x: torch.Tensor, blk: _Conv, slope: float) -> torch.Tensor:
    """NCHW (channels_last) -> bf16 conv, affine, LeakyReLU, 2x2 max pool.

    The LeakyReLU's slope is the bf16 one, as in the JAX package's
    ``_conv_block_eval``; the bf16 x bf16 product is exact in the kernel's
    f32 arithmetic and rounds once, as XLA's does."""
    y = F.conv2d(x.to(_BF16), blk.weight, padding=1)
    y = F.leaky_relu(y * blk.scale + blk.bias, bf16_value(slope))
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


def make_first_block(cfg: ModelConfig, state_dict: StateDict,
                     use_kernel: bool = True) -> Callable:
    """Block 0 of every branch, shared by the bf16 and the int8 forwards and
    the int8 calibration, so the three cannot diverge.

    -> ``first(batch_nhwc)`` -> one (B, F, H/2, W/2) bf16 channels_last
    tensor per branch. Through the gate (``_kernel_gate``) and with
    ``use_kernel`` it is one fused input-block call: the HWIO kernel and
    affine packed once here; for the two-branch model both branches' C=1
    kernels stacked block-diagonally into one C=2 -> 2F call (bleed reads
    channel 0 into [:F], source channel 1 into [F:]), exactly the flagship
    single-branch kernel shape. Otherwise each branch's block 0 runs on the
    bf16 conv path of ``_conv_block_eval`` (the exported programs' route:
    ``use_kernel=False``).
    """
    eps, slope, double = cfg.bn_eps, cfg.leaky_slope, cfg.variant == "double"
    sd = state_dict
    prefixes = [p for p, _ in structure(cfg.variant)[0]]
    packed = None
    if use_kernel:
        first = [_block_affine(sd, p, 0, eps) for p in prefixes]
        if double:
            (kb, sb, bb), (ks, ss, bs) = first
            f = kb.shape[-1]
            k0 = torch.zeros((3, 3, 2, 2 * f), dtype=kb.dtype, device=kb.device)
            k0[:, :, 0:1, :f] = kb
            k0[:, :, 1:2, f:] = ks
            packed = pack_input_block(k0, torch.cat([sb, ss]), torch.cat([bb, bs]))
        else:
            packed = pack_input_block(*first[0])
    convs = [_fold_conv(sd, p, 0, eps) for p in prefixes]

    def run(x: torch.Tensor) -> List[torch.Tensor]:
        if packed is not None and _kernel_gate(x):
            z = fused_input_block_packed(x, packed, slope=slope).permute(0, 3, 1, 2)
            f = z.shape[1] // len(convs)
            feats = [z[:, i * f:(i + 1) * f] for i in range(len(convs))]
            return [a.contiguous(memory_format=torch.channels_last) for a in feats]
        x_nchw = x.permute(0, 3, 1, 2)
        feats = [x_nchw[:, 0:1], x_nchw[:, 1:2]] if double else [x_nchw]
        return [_conv_block_eval(a.contiguous(memory_format=torch.channels_last), blk, slope)
                for a, blk in zip(feats, convs)]

    return run


def head_weights(cfg: ModelConfig, state_dict: StateDict):
    """-> (the first dense weight with its columns in channels_last (H, W, C)
    flatten order, f32; the second dense weight, f32).

    The torch head flattens NCHW as (C, H, W); the forwards flatten
    channels_last activations as (H, W, C), so the first head weight is
    permuted once. C counts the concatenated bleed-then-source channels."""
    sd = state_dict
    branches, head = structure(cfg.variant)
    channels = sum(sd[f"{p}.{4 * (count_blocks(sd, p) - 1)}.weight"].shape[0]
                   for p, _ in branches)
    w1 = sd[f"{head}.1.weight"]
    side = math.isqrt(w1.shape[1] // channels)
    w1 = w1.reshape(w1.shape[0], channels, side, side).permute(0, 2, 3, 1)
    return w1.reshape(w1.shape[0], -1).float(), sd[f"{head}.5.weight"].float()


def make_fast_forward(cfg: ModelConfig, state_dict: StateDict,
                      use_kernel: bool = True) -> Callable:
    """-> ``forward(batch_nhwc) -> (B, 1) float32`` predictions.

    The folded weights live on the state_dict's device; ``batch_nhwc`` is a
    normalized (B, H, W, 2) float32 batch on that device. ``use_kernel=False``
    runs block 0 on the bf16 conv path instead of the fused input-block
    kernel (the AOT export's program, ``io/export.py``)."""
    require_cnn(cfg.variant, "the --fast tier (folded BatchNorm, kernel K1)")
    eps, slope, double = cfg.bn_eps, cfg.leaky_slope, cfg.variant == "double"
    sd = state_dict
    branches, head = structure(cfg.variant)
    prefixes = [p for p, _ in branches]
    first = make_first_block(cfg, sd, use_kernel)
    convs: List[List[_Conv]] = [
        [_fold_conv(sd, p, i, eps) for i in range(1, count_blocks(sd, p))]
        for p in prefixes
    ]
    w1, w5 = head_weights(cfg, sd)
    dense = [_fold_dense(sd, head, 1, 2, eps, w1), _fold_dense(sd, head, 5, 6, eps, w5)]
    w_out = sd[f"{head}.9.weight"].to(_BF16).contiguous()
    b_out = sd[f"{head}.9.bias"].float()

    def forward(x: torch.Tensor) -> torch.Tensor:
        feats = []
        for h, blocks in zip(first(x), convs):
            for blk in blocks:
                h = _conv_block_eval(h, blk, slope)
            feats.append(h)
        h = torch.cat(feats, dim=1)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        for d in dense:
            h = _dense_bn_eval(h, d, slope)
        out = _matmul_f32(h, w_out) + b_out
        if double:
            out = torch.sigmoid(out) * 0.5
        return out

    return forward
