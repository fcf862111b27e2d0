"""Fused input ConvBlock: conv3x3(SAME) -> folded-BN affine -> LeakyReLU ->
maxpool 2x2, for few-channel inputs (port of
crosstalk_tpu/ops/pallas/input_block.py).

``pack_input_block`` turns ``(kernel, scale, bias)`` into what the kernel
reads, once: the bf16 folded kernel ``kernel * scale``, the same values in
the kernel's padded GEMM layout, and the f32 bias. ``fused_input_block_packed``
takes the packed weights (the fast forward packs once per model);
``fused_input_block`` keeps the JAX signature, packs and calls it. On a CUDA
tensor the packed entry launches the hand-written tensor-core kernel
``csrc/input_block.cu`` (built at first use, see ``_build.py``; its source
note gives the design and the bound); on a CPU tensor it runs the plain
PyTorch version of the same arithmetic on the same bf16 values. There is no
fallback between the two: a CUDA call launches the kernel or raises.

The (B, H/2, W/2, F) NHWC output is the channels_last memory of an NCHW
tensor, so ``out.permute(0, 3, 1, 2)`` hands it to cuDNN without a copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.ops import _build


def fold_bn_affine(conv_bias, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold eval-mode BatchNorm (+ the conv bias) into (scale, bias)."""
    scale = bn_scale * torch.rsqrt(bn_var + eps)
    bias = (conv_bias - bn_mean) * scale + bn_bias
    return scale, bias


def _check_shapes(x, kernel, scale, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    _, h, w, c = x.shape
    if c > 4 or h % 2 or w % 2:
        raise ValueError(
            f"fused_input_block takes C <= 4 and even H, W; got {tuple(x.shape)}")
    if kernel.shape[:3] != (3, 3, c):
        raise ValueError(f"kernel must be (3, 3, {c}, F), got {tuple(kernel.shape)}")
    f = kernel.shape[3]
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"scale and bias must be ({f},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")


def fused_input_block_reference(x, kernel, scale, bias, *, slope: float = 0.01):
    """Plain PyTorch version: x and ``kernel * scale`` rounded to bf16, an
    f32 conv, the 2x2 max, + bias, LeakyReLU, cast to bf16. NHWC in and out."""
    _check_shapes(x, kernel, scale, bias)
    return _reference_folded(x, _fold_kernel(kernel, scale), bias, slope)


def _fold_kernel(kernel, scale):
    return (kernel.float() * scale.float()).to(torch.bfloat16)


def _reference_folded(x, folded, bias, slope):
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    y = F.conv2d(xb, folded.float().permute(3, 2, 0, 1), padding=1)
    y = F.max_pool2d(y, 2) + bias.float().view(1, -1, 1, 1)
    y = F.leaky_relu(y, slope)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


CHANNEL_SLICE = 128  # output channels per kernel block; F is padded to it


def padded_taps(c: int) -> int:
    """K', the kernel's GEMM depth for C input channels: the 9*C taps padded
    to m16n8k16 steps plus at most one m16n8k8 tail (KSteps in the source):
    C=1 16, C=2 24, C=3 32, C=4 40."""
    k = 9 * c
    full, rem = divmod(k, 16)
    return 16 * full + (0 if rem == 0 else 8 if rem <= 8 else 16)


class PackedInputBlock(NamedTuple):
    """Weights of one fused input block as the kernel reads them.

    folded: (3, 3, C, F) bf16, ``kernel * scale`` rounded (the CPU path).
    gemm:   (F', K') bf16, row f = output channel f, column k = tap
            (dh, dw, c) at k = (3 * dh + dw) * C + c; K' = padded_taps(C),
            F' = F rounded up to CHANNEL_SLICE; padded rows and columns 0.
    bias:   (F',) f32, zero padded.
    """
    folded: torch.Tensor
    gemm: torch.Tensor
    bias: torch.Tensor

    @property
    def features(self) -> int:
        return self.folded.shape[3]


def pack_input_block(kernel, scale, bias) -> PackedInputBlock:
    """Fold the BN scale into the weights and lay them out for the kernel."""
    c, f = kernel.shape[2], kernel.shape[3]
    if kernel.shape[:2] != (3, 3) or c > 4:
        raise ValueError(f"kernel must be (3, 3, C <= 4, F), got {tuple(kernel.shape)}")
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"scale and bias must be ({f},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    folded = _fold_kernel(kernel, scale).contiguous()
    f_pad = -(-f // CHANNEL_SLICE) * CHANNEL_SLICE
    gemm = torch.zeros((f_pad, padded_taps(c)), dtype=torch.bfloat16, device=kernel.device)
    gemm[:f, :9 * c] = folded.reshape(9 * c, f).t()
    bias_pad = torch.zeros(f_pad, dtype=torch.float32, device=kernel.device)
    bias_pad[:f] = bias.float()
    return PackedInputBlock(folded, gemm, bias_pad)


def _launcher():
    """The C entry point, with pointers and the stream as c_void_p (a
    default ctypes int would cut a 64-bit pointer)."""
    fn = _build.load("input_block").fused_input_block_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                   ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def kernel_resources(c_in: int) -> dict:
    """The CUDA kernel's registers per thread, static shared and local
    (spill) memory per block in bytes, threads per block and resident
    blocks per SM, for ``c_in`` input channels, on the current card."""
    fn = _build.load("input_block").fused_input_block_resources
    vals = [ctypes.c_int(0) for _ in range(5)]
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    rc = fn(c_in, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"fused_input_block_resources failed: CUDA error {rc}")
    keys = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm", "threads")
    return dict(zip(keys, (v.value for v in vals)))


def fused_input_block_packed(x, packed: PackedInputBlock, *, slope: float = 0.01):
    """``fused_input_block`` on weights packed once by ``pack_input_block``.

    On a CPU tensor: the plain version on ``packed.folded``. On a CUDA
    tensor: the kernel, counted in ``fused_input_block.launches``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c != packed.folded.shape[2] or h % 2 or w % 2:
        raise ValueError(f"fused_input_block takes C = {packed.folded.shape[2]} "
                         f"(the packed kernel's) and even H, W; got {tuple(x.shape)}")
    f = packed.features
    if x.device.type == "cpu":
        return _reference_folded(x, packed.folded, packed.bias[:f], slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_input_block runs on cuda or cpu, got {x.device}")
    for name, t in zip(packed._fields, packed):
        if t.device != x.device:
            raise ValueError(f"packed {name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32 on CUDA, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, H, W, C)")

    out = torch.empty((b, h // 2, w // 2, f), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            x.data_ptr(), packed.gemm.data_ptr(), packed.bias.data_ptr(),
            out.data_ptr(), b, h, w, c, f, float(slope), stream)
    if rc != 0:
        raise RuntimeError(f"fused_input_block kernel launch failed: CUDA error {rc}")
    fused_input_block.launches += 1
    return out


def fused_input_block(x, kernel, scale, bias, *, slope: float = 0.01):
    """Fused conv3x3(SAME) -> (*scale + bias) -> LeakyReLU -> maxpool2x2.

    x: (B, H, W, C) with C <= 4 and H, W even; float32 on CUDA (any float
    dtype on the CPU). kernel: (3, 3, C, F) HWIO conv weights. scale, bias:
    (F,) eval-mode folded BatchNorm affine (``fold_bn_affine``).
    -> (B, H/2, W/2, F) bfloat16, NHWC contiguous.

    Packs the weights on every call; a caller with fixed weights packs once
    and calls ``fused_input_block_packed``. ``fused_input_block.launches``
    counts kernel launches of both entries (CPU calls do not count).
    """
    _check_shapes(x, kernel, scale, bias)
    for name, t in (("kernel", kernel), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return fused_input_block_packed(x, pack_input_block(kernel, scale, bias), slope=slope)


fused_input_block.launches = 0
