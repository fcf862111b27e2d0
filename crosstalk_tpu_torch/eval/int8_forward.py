"""Opt-in int8 serving tier: the post-training-quantized eval forward (port
of crosstalk_tpu/eval/int8_forward.py).

The scheme is the JAX package's (symmetric post-training quantization, v2
calibration):

  * weights: per-output-channel symmetric int8, quantized from the served
    float weights (no second checkpoint format);
  * activations: per-tensor symmetric int8 against a clip that
    ``calibrate_int8`` records at every quantize point from one
    representative batch: by default the MSE-optimal clip over a swept
    fraction of the batch absmax (``method="mse"``), or the raw absmax
    (``method="absmax"``, the v1 scheme);
  * each conv of blocks 1+ computes in int8 with an int32 accumulator; the
    dequantization constant folds into the BatchNorm affine, then the
    epilogue is the f32 affine, a cast to bf16, LeakyReLU in bf16 with a
    bf16 slope and the 2x2 max pool, as in the JAX package;
  * block 0 (1-2 input channels) runs through ``make_first_block``, the
    fused input-block kernel on the card, exactly as in the bf16 forward;
    the two FC+BN head blocks stay bf16 with f32 products unless the scales
    carry ``dense_*`` clips (``int8_dense=True`` calibrations); the final
    dense stays bf16 with an f32 product.

The int8 products are ``torch._int_mm``: cuBLASLt s8 x s8 -> s32 on the
card, exact int32 arithmetic on the CPU, so the quantized region computes
the same integers on both. A 3x3 conv is one product over the 9x im2col of
the zero-padded int8 activations (K = 9 * C_in). Nine shifted-tap products
(K = C_in each) avoid the im2col but write and add an M x N int32 product
per tap: at block 1 with a batch of 256 they took 51.1 ms and 12.9 GiB of
extra device memory against 17.7 ms and 9.0 GiB for the im2col product
(CUDA events on an H100 80GB HBM3 at 700 W). Quantization
error is far outside the 1e-4 parity budget; the tier is opt-in
(DEPLOY.md's parity map gives the JAX package's measured deviation).

Same contract as ``make_fast_forward``: ``forward(batch_nhwc) -> (B, 1)``
float32 alphas.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.config import ModelConfig, require_cnn
from crosstalk_tpu_torch.eval.fast_forward import (
    _block_affine,
    _conv_block_eval,
    _dense_bn_eval,
    _fold_conv,
    _fold_dense,
    _matmul_f32,
    bf16_value,
    head_weights,
    make_first_block,
)
from crosstalk_tpu_torch.io.torch_convert import StateDict, count_blocks, structure
from crosstalk_tpu_torch.ops.input_block import fold_bn_affine

_BF16 = torch.bfloat16
# torch._int_mm on CUDA takes more than 16 rows; the head's rows are the
# batch (a serve bucket can be 8), so they are padded with this many zeros
_PAD_ROWS = 16


def _div(a, b, device) -> torch.Tensor:
    """``a / b`` in f32 as an IEEE division on every device. torch computes
    ``tensor / number`` on the card, and ``number / tensor`` everywhere, as
    a product with a rounded reciprocal, which rounds differently from the
    JAX package's division and from the other device; two tensors on one
    device divide exactly."""
    return torch.div(torch.as_tensor(a, dtype=torch.float32, device=device),
                     torch.as_tensor(b, dtype=torch.float32, device=device))


def _quant_weight(k: torch.Tensor):
    """Per-output-channel symmetric int8. k: (..., C_out) ->
    (k_q int8, sw f32 (C_out,)) with k ~= k_q * sw."""
    k = k.float()
    absmax = k.abs().amax(dim=tuple(range(k.dim() - 1)))
    sw = _div(torch.clamp(absmax, min=1e-12), 127.0, k.device)
    kq = torch.clamp(torch.round(k / sw), -127, 127).to(torch.int8)
    return kq, sw


# clip-search grid for method="mse": fractions of the batch absmax. 1.0 is
# always a candidate so the MSE scheme can never do worse than absmax on the
# calibration batch itself.
_MSE_CLIP_RATIOS = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4, 0.35, 0.3, 0.25, 0.2)


def _mse_clip(h: torch.Tensor) -> torch.Tensor:
    """MSE-optimal symmetric int8 clip for tensor ``h``, a 0-dim f32 tensor.

    Sweeps clips c = ratio * absmax(|h|) and returns the one minimizing
    mean((quant_dequant(h, c) - h)^2): 12 reductions, one after another,
    each through one temporary the size of ``h`` (no candidates x tensor
    intermediate on multi-GB calibration activations)."""
    h = h.float()
    absmax = h.abs().amax()
    clips, errs = [], []
    for r in _MSE_CLIP_RATIOS:
        c = absmax * r
        s = _div(torch.clamp(c, min=1e-12), 127.0, h.device)
        err = (h / s).round_().clamp_(-127, 127).mul_(s).sub_(h).square_().mean()
        clips.append(c)
        errs.append(err)
    return torch.stack(clips)[torch.argmin(torch.stack(errs))]


def _absmax_clip(h: torch.Tensor) -> torch.Tensor:
    return h.float().abs().amax()


def _act_scale(sx, device) -> torch.Tensor:
    """The quantization multiplier ``127 / max(sx, 1e-12)`` in f32."""
    sx = torch.as_tensor(sx, dtype=torch.float32, device=device)
    return _div(127.0, torch.clamp(sx, min=1e-12), device)


def _quantize(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    return (x.float() * qs).round_().clamp_(-127, 127).to(torch.int8)


def _quant_act(x: torch.Tensor, sx) -> torch.Tensor:
    """Per-tensor symmetric int8 against the calibrated clip ``sx``.
    Inputs outside the calibration range saturate (standard PTQ)."""
    return _quantize(x, _act_scale(sx, x.device))


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact on both devices.

    On the card this is cuBLASLt's s8 x s8 -> s32 GEMM, which takes more
    than 16 rows and K, N multiples of 8. So K (the columns of ``a`` and the
    rows of ``b``) and N (the columns of ``b``, sliced off the product) are
    zero-padded to multiples of 8 on every device, which adds exact zeros
    to the int32 sums, as the JAX int8 conv and dense take any width
    (crosstalk_tpu/eval/int8_forward.py:107-114, :136-141); on the card, 16
    rows or fewer are padded with zero rows. ``b`` keeps its memory order
    (the weights are stored column-major)."""
    m, k = a.shape
    n = b.shape[1]
    pad_k, pad_n = -k % 8, -n % 8
    if pad_k:
        a = F.pad(a, (0, pad_k))
    if pad_k or pad_n:
        b = F.pad(b.t(), (0, pad_k, 0, pad_n)).t()
    if a.is_cuda and m <= _PAD_ROWS:
        out = torch._int_mm(F.pad(a, (0, 0, 0, _PAD_ROWS + 1 - m)), b)[:m]
    else:
        out = torch._int_mm(a, b)
    return out[:, :n] if pad_n else out


def _conv3x3_int8(xq: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv3x3 (SAME) of int8 NHWC ``xq`` (B, H, W, C) with ``weight``
    (N, 9 * C) int8 (column (3 * dh + dw) * C + c) -> (B, H, W, N) int32
    accumulators: one GEMM over the im2col of the zero-padded input."""
    b, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dh:dh + h, dw:dw + w, :] for dh in range(3) for dw in range(3)],
                     dim=-1)
    return _int_mm(cols.reshape(-1, 9 * c), weight.t()).view(b, h, w, -1)


def _int8_epilogue(acc: torch.Tensor, eff_scale: torch.Tensor, bias: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """int32 NHWC accumulators -> f32 affine (dequantization folded into
    the BN scale) -> bf16 -> LeakyReLU in bf16 with the bf16 slope -> 2x2
    max pool -> (B, H/2, W/2, N) bf16 NHWC."""
    y = F.leaky_relu((acc.float() * eff_scale + bias).to(_BF16), bf16_value(slope))
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Int8Conv(NamedTuple):
    """One quantized conv block, prepared once per model."""
    qs: torch.Tensor         # 0-dim f32: 127 / the input's calibrated clip
    weight: torch.Tensor     # (N, 9 * C) int8, column (3 * dh + dw) * C + c
    eff_scale: torch.Tensor  # (N,) f32: BN scale * weight scale * sx / 127
    bias: torch.Tensor       # (N,) f32 folded BN bias


def prepare_conv_int8(kernel, scale, bias, sx) -> Int8Conv:
    """HWIO f32 ``kernel``, folded BN ``scale``/``bias`` and the clip ``sx``
    -> the block's int8 GEMM weight and f32 epilogue constants, computed in
    the JAX package's order: ``scale * sw * (sx / 127)`` in f32."""
    kq, sw = _quant_weight(kernel)
    weight = kq.reshape(-1, kq.shape[3]).t().contiguous()
    eff_scale = scale.float() * sw * _div(sx, 127.0, sw.device)
    return Int8Conv(_act_scale(sx, sw.device), weight, eff_scale, bias.float())


def conv_block_int8(x: torch.Tensor, blk: Int8Conv, slope: float) -> torch.Tensor:
    """A prepared block on NHWC ``x`` -> (B, H/2, W/2, N) bf16 NHWC."""
    return _int8_epilogue(_conv3x3_int8(_quantize(x, blk.qs), blk.weight),
                          blk.eff_scale, blk.bias, slope)


def _conv_block_int8(x, sx, kernel, scale, bias, slope):
    """conv3x3(int8) -> folded BN affine (dequant included) -> LeakyReLU ->
    maxpool 2x2, NHWC in and out: the JAX package's signature."""
    return conv_block_int8(x, prepare_conv_int8(kernel, scale, bias, sx), slope)


class _Int8Dense(NamedTuple):
    qs: torch.Tensor         # 0-dim f32: 127 / the input's calibrated clip
    weight: torch.Tensor     # (in, out) int8, column-major (out, in) storage
    eff_scale: torch.Tensor  # (out,) f32
    bias: torch.Tensor       # (out,) f32


def _prepare_dense_int8(sd: StateDict, head: str, lin: int, bn: int, eps: float,
                        weight: torch.Tensor, sx) -> _Int8Dense:
    scale, bias = fold_bn_affine(
        sd[f"{head}.{lin}.bias"], sd[f"{head}.{bn}.weight"], sd[f"{head}.{bn}.bias"],
        sd[f"{head}.{bn}.running_mean"], sd[f"{head}.{bn}.running_var"], eps,
    )
    kq, sw = _quant_weight(weight.float().t())  # (in, out), per output channel
    eff_scale = scale.float() * sw * _div(sx, 127.0, sw.device)
    return _Int8Dense(_act_scale(sx, sw.device), kq.t().contiguous().t(), eff_scale,
                      bias.float())


def _dense_bn_int8(x: torch.Tensor, d: _Int8Dense, slope: float) -> torch.Tensor:
    """int8 FC + folded BN + LeakyReLU in f32. The rows are padded with
    zeros for ``_int_mm`` on every device, so the batch never decides the
    route."""
    xq = F.pad(_quantize(x, d.qs), (0, 0, 0, _PAD_ROWS))
    y = _int_mm(xq, d.weight)[:x.shape[0]]
    return F.leaky_relu(y.float() * d.eff_scale + d.bias, slope)


def _state_device(state_dict: StateDict) -> torch.device:
    return next(iter(state_dict.values())).device


def load_calibration_tiles(mixed_dir: str, source_dir: str, image_size: int,
                           max_tiles: int = 256, jobs: int = 4) -> np.ndarray:
    """Pair, decode and normalize up to ``max_tiles`` tile pairs for
    activation-range calibration: the loader behind the serve CLI's
    ``--calibration_*`` flags and the export tool's ``--quantize int8``.

    -> (n, image_size, image_size, 2) f32 normalized array. Raises
    ValueError (pairing, decode, shape) or FileNotFoundError.
    """
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc

    index = pair_unlabeled(mixed_dir, source_dir)
    tiles = load_tiles(index.samples[:max_tiles], jobs=jobs)
    n, h, w, _ = tiles.shape
    if h != image_size or w != image_size:
        raise ValueError(
            f"calibration tiles are {h}x{w} but the serving tile size is "
            f"{image_size}px — calibrate on tiles of the serving shape "
            "(grid large acquisitions with cli/predict first)")
    return normalize_batch_nhwc(torch.from_numpy(tiles)).numpy()


@torch.inference_mode()
def calibrate_int8(
    cfg: ModelConfig,
    state_dict: StateDict,
    batch,
    use_kernel: bool = True,
    method: str = "mse",
    int8_dense: bool = False,
) -> Dict[str, float]:
    """Run one representative normalized batch (n, H, W, 2) through the bf16
    serving path (block 0 through ``make_first_block``, so the fused
    input-block kernel on the card) and record an activation clip at every
    int8 quantize point.

    -> dict of clips, the ``scales`` argument of ``make_int8_forward``: keys
    ``conv_{i}`` (single-branch) or ``bleed_{i}``/``source_{i}``
    (two-branch) for blocks i >= 1, plus ``dense_0``/``dense_1`` with
    ``int8_dense``. Runs on the state_dict's device. Calibrate on data from
    the serving distribution; inputs beyond a clip saturate when served.

    ``method``: "mse" (the default, ``_mse_clip``) or "absmax" (v1).
    ``int8_dense``: also record clips for the two FC+BN head blocks so
    ``make_int8_forward`` runs them in int8 (v1 behaviour).
    """
    require_cnn(cfg.variant, "the int8 tier")
    if method not in ("mse", "absmax"):
        raise ValueError(f"unknown calibration method {method!r}")
    clip = _mse_clip if method == "mse" else _absmax_clip
    eps, slope = cfg.bn_eps, cfg.leaky_slope
    sd = state_dict
    branches, head = structure(cfg.variant)
    names = ["bleed_", "source_"] if cfg.variant == "double" else ["conv_"]
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.asarray(batch, np.float32))
    x = batch.to(_state_device(sd), torch.float32)
    scales: Dict[str, torch.Tensor] = {}
    feats = []
    for h, (prefix, _), name in zip(make_first_block(cfg, sd, use_kernel)(x),
                                    branches, names):
        for i in range(1, count_blocks(sd, prefix)):
            scales[f"{name}{i}"] = clip(h)
            h = _conv_block_eval(h, _fold_conv(sd, prefix, i, eps), slope)
        feats.append(h)
    h = torch.cat(feats, dim=1)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    if int8_dense:
        w1, w5 = head_weights(cfg, sd)
        for i, (lin, bn, w) in enumerate(((1, 2, w1), (5, 6, w5))):
            scales[f"dense_{i}"] = clip(h)
            h = _dense_bn_eval(h, _fold_dense(sd, head, lin, bn, eps, w), slope)
    return {k: float(v) for k, v in scales.items()}


def make_int8_forward(cfg: ModelConfig, state_dict: StateDict,
                      scales: Dict[str, float], use_kernel: bool = True) -> Callable:
    """-> ``forward(batch_nhwc) -> (B, 1) float32`` predictions with every
    conv after block 0 computed as int8 products. The two FC+BN head blocks
    run in int8 only when ``scales`` carries their ``dense_*`` clips;
    otherwise they stay on the bf16 path.

    ``scales`` comes from ``calibrate_int8`` and must match the model's
    variant and depth: a missing conv key raises KeyError here. The weights
    are quantized once, on the state_dict's device. ``use_kernel=False``
    runs block 0 on the bf16 conv path (the AOT export's program).
    Accuracy is NOT within the 1e-4 parity budget.
    """
    require_cnn(cfg.variant, "the int8 tier")
    first = make_first_block(cfg, state_dict, use_kernel)
    trunk = make_int8_trunk(cfg, state_dict, scales)
    head = make_int8_head(cfg, state_dict, scales)

    def forward(x: torch.Tensor) -> torch.Tensor:
        return head(trunk(first(x)))

    return forward


# Block 0 is the one part of the int8 forward whose rounding differs between
# the card (the fused kernel) and the CPU (its plain version); the trunk and
# the head are separate so that each can be held across devices from one input.

def make_int8_trunk(cfg: ModelConfig, state_dict: StateDict,
                    scales: Dict[str, float]) -> Callable:
    """-> ``trunk(block0_outputs) -> (B, H * W * C) bf16``: the int8 conv
    blocks 1+ of every branch on the per-branch outputs of
    ``make_first_block``, concatenated (bleed, then source) and flattened
    channels_last, as the head takes them."""
    eps, slope = cfg.bn_eps, cfg.leaky_slope
    sd = state_dict
    names = ["bleed_", "source_"] if cfg.variant == "double" else ["conv_"]
    trunks: List[List[Int8Conv]] = [
        [prepare_conv_int8(*_block_affine(sd, prefix, i, eps), scales[f"{name}{i}"])
         for i in range(1, count_blocks(sd, prefix))]
        for (prefix, _), name in zip(structure(cfg.variant)[0], names)
    ]

    def trunk(block0_outputs) -> torch.Tensor:
        feats = []
        for h, blocks in zip(block0_outputs, trunks):
            h = h.permute(0, 2, 3, 1)  # channels_last NCHW -> NHWC view
            for blk in blocks:
                h = conv_block_int8(h, blk, slope)
            feats.append(h)
        h = torch.cat(feats, dim=-1)
        return h.reshape(h.shape[0], -1)

    return trunk


def make_int8_head(cfg: ModelConfig, state_dict: StateDict,
                   scales: Dict[str, float]) -> Callable:
    """-> ``head(features) -> (B, 1) float32``: the two FC+BN blocks (int8
    where ``scales`` carries ``dense_*`` clips, else bf16 with f32
    products), the final dense and, for the two-branch model, the scaled
    sigmoid."""
    eps, slope, double = cfg.bn_eps, cfg.leaky_slope, cfg.variant == "double"
    sd = state_dict
    head = structure(cfg.variant)[1]
    w1, w5 = head_weights(cfg, sd)
    dense = []
    for i, (lin, bn, w) in enumerate(((1, 2, w1), (5, 6, w5))):
        if f"dense_{i}" in scales:
            dense.append(_prepare_dense_int8(sd, head, lin, bn, eps, w, scales[f"dense_{i}"]))
        else:
            dense.append(_fold_dense(sd, head, lin, bn, eps, w))
    w_out = sd[f"{head}.9.weight"].to(_BF16).contiguous()
    b_out = sd[f"{head}.9.bias"].float()

    def run(h: torch.Tensor) -> torch.Tensor:
        for d in dense:
            h = (_dense_bn_int8(h, d, slope) if isinstance(d, _Int8Dense)
                 else _dense_bn_eval(h, d, slope))
        out = _matmul_f32(h, w_out) + b_out
        if double:
            out = torch.sigmoid(out) * 0.5
        return out

    return run
