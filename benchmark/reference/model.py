"""Plain float32 forward of the two published regressors, written from their
published description and nothing else (djpbarry/Torch-Unet
``regression_model.py`` and ``two_branch_regression.py``).

* ``single`` (AdvancedRegressionModel): ``num_conv_blocks`` blocks of
  conv3x3 (pad 1) -> BatchNorm2d -> LeakyReLU(0.01) -> maxpool 2x2, the
  widths doubling from ``initial_filters`` up to ``max_filters``; then
  flatten (C, H, W) -> Linear(512) -> BatchNorm1d -> LeakyReLU -> Dropout ->
  Linear(128) -> BatchNorm1d -> LeakyReLU -> Dropout -> Linear(1).
* ``double`` (SimplifiedTwoBranchRegressionModel): two independent 4-block
  encoders (channel 0 and channel 1, widths f, 2f, 4f, 8f), their maps
  concatenated (channel 0's first), the same head, then sigmoid x 0.5.

Weights are a dict in the published ``.pth`` key schema. The input is a
raw (B, H, W, 2) batch; each (tile, channel) plane is min-max normalized
first, and a constant plane passes through unchanged.

``precision`` names the arithmetic of the convolutions and the dense
layers: ``"f32"`` (the reference; TF32 must be off, see ``plain_numerics``),
``"bf16"``, ``"fp8"`` or ``"int8"`` (the operands and the outputs of those
layers rounded to that type, with a per-tensor scale for fp8 e4m3 and a
symmetric per-tensor one for int8; the products
still sum in float32, as tensor cores sum them). The two lower ones exist
only as controls: a computation that a comparison has to reject. In them
the gradient passes the rounding unchanged.

This file imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]
# BatchNorm key -> (batch mean, unbiased batch variance) of one forward
BatchStats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def plain_numerics() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def branches(config: dict) -> Tuple[List[Tuple[str, List[int]]], str]:
    """-> ([(key prefix, [channel widths from input to last block])],
    head key prefix)."""
    if config["variant"] == "single":
        widths = [config["input_channels"], config["initial_filters"]]
        for _ in range(1, config["num_conv_blocks"]):
            widths.append(min(widths[-1] * 2, config["max_filters"]))
        return [("conv_layers", widths)], "fc_layers"
    f = config["initial_filters_per_branch"]
    widths = [1, f, 2 * f, 4 * f, 8 * f]
    return ([("bleed_branch.conv_blocks", widths),
             ("source_branch.conv_blocks", widths)], "regression_head.fc_layers")


def flat_features(config: dict) -> int:
    convs, _ = branches(config)
    side = config["image_size"] >> (len(convs[0][1]) - 1)
    return sum(w[-1] for _, w in convs) * side * side


def weight_shapes(config: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """-> {key: (shape, kind)} in the published schema, where kind is
    ``conv``/``linear`` (weight or bias of a layer), ``bn`` (affine),
    ``stat`` (running statistics) or ``count``."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    convs, head = branches(config)
    for prefix, widths in convs:
        for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
            out[f"{prefix}.{4 * i}.weight"] = ((cout, cin, 3, 3), "conv")
            out[f"{prefix}.{4 * i}.bias"] = ((cout,), "conv")
            _bn(out, f"{prefix}.{4 * i + 1}", cout)
    fins = [(1, flat_features(config), 512), (5, 512, 128)]
    for lin, fin, fout in fins:
        out[f"{head}.{lin}.weight"] = ((fout, fin), "linear")
        out[f"{head}.{lin}.bias"] = ((fout,), "linear")
        _bn(out, f"{head}.{lin + 1}", fout)
    out[f"{head}.9.weight"] = ((1, 128), "linear")
    out[f"{head}.9.bias"] = ((1,), "linear")
    return out


def _bn(out, key, n):
    out[f"{key}.weight"] = ((n,), "bn")
    out[f"{key}.bias"] = ((n,), "bn")
    out[f"{key}.running_mean"] = ((n,), "stat")
    out[f"{key}.running_var"] = ((n,), "stat")
    out[f"{key}.num_batches_tracked"] = ((), "count")


def trainable(config: dict) -> List[str]:
    """Keys of the parameters an optimizer updates, in module order."""
    return [k for k, (_, kind) in weight_shapes(config).items()
            if kind in ("conv", "linear", "bn")]


def running_stats(config: dict) -> List[str]:
    """Keys of the BatchNorm running statistics, in module order."""
    return [k for k, (_, kind) in weight_shapes(config).items() if kind == "stat"]


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) raw -> per (tile, channel) min-max to [0, 1]."""
    lo = raw.amin(dim=(1, 2), keepdim=True)
    hi = raw.amax(dim=(1, 2), keepdim=True)
    span = hi - lo
    return torch.where(span > 0, (raw - lo) / torch.where(span > 0, span, 1.0), raw)


class _Round(torch.autograd.Function):
    """Operand rounding of the control precisions; the gradient passes."""

    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        if precision == "int8":
            step = x.detach().abs().amax().clamp_min(1e-30) / 127.0
            return torch.round(x / step).clamp(-127, 127) * step
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax  # e4m3's largest finite value
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def _op(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x if precision == "f32" else _Round.apply(x, precision)


class BatchNormMode:
    """How a forward treats BatchNorm: ``eval`` (running statistics),
    ``train`` (batch statistics, biased variance) or ``calibrate`` (batch
    statistics, which are also written into the weights as the running
    ones, the unbiased variance as BatchNorm keeps it)."""

    EVAL, TRAIN, CALIBRATE = "eval", "train", "calibrate"


def _batch_norm(y: torch.Tensor, w: Weights, key: str, mode: str, eps: float,
                stats: Optional[BatchStats] = None):
    if mode == BatchNormMode.EVAL:
        return F.batch_norm(y, w[f"{key}.running_mean"], w[f"{key}.running_var"],
                            w[f"{key}.weight"], w[f"{key}.bias"], False, 0.0, eps)
    if mode == BatchNormMode.CALIBRATE or stats is not None:
        dims = [0] + list(range(2, y.dim()))
        with torch.no_grad():
            mean, var = y.mean(dims), y.var(dims, unbiased=True)
        if mode == BatchNormMode.CALIBRATE:
            w[f"{key}.running_mean"].copy_(mean)
            w[f"{key}.running_var"].copy_(var)
        if stats is not None:
            stats[key] = (mean, var)
    return F.batch_norm(y, None, None, w[f"{key}.weight"], w[f"{key}.bias"],
                        True, 0.0, eps)


def _conv_block(x, w, key, mode, precision, slope, eps, stats=None):
    y = _op(F.conv2d(_op(x, precision), _op(w[f"{key}.weight"], precision),
                     w[f"{key}.bias"], padding=1), precision)
    bn = key.rsplit(".", 1)
    y = _batch_norm(y, w, f"{bn[0]}.{int(bn[1]) + 1}", mode, eps, stats)
    return F.max_pool2d(F.leaky_relu(y, slope), 2)


def forward(config: dict, w: Weights, raw: torch.Tensor, *,
            bn: str = BatchNormMode.EVAL, precision: str = "f32",
            dropout_masks: Optional[List[torch.Tensor]] = None,
            flips: Optional[torch.Tensor] = None,
            recompute: bool = False,
            bn_stats: Optional[BatchStats] = None) -> torch.Tensor:
    """Raw (B, H, W, 2) tiles -> (B,) predictions.

    ``flips`` (B, 2) bool flips each normalized sample horizontally (column
    0) and vertically (column 1), both channels together. ``dropout_masks``
    are the two head dropouts' keep masks (1 or 0), applied as
    ``x * mask / (1 - p)``. ``recompute`` recomputes each conv block's
    activations in the backward instead of keeping them. ``bn_stats``, in
    train mode, receives each BatchNorm's batch statistics (a recomputed
    block writes the same values again)."""
    slope, eps = config["leaky_slope"], config["bn_eps"]
    x = normalize(raw)
    if flips is not None:
        x = torch.where(flips[:, 0].view(-1, 1, 1, 1), x.flip(2), x)
        x = torch.where(flips[:, 1].view(-1, 1, 1, 1), x.flip(1), x)
    x = x.permute(0, 3, 1, 2)
    convs, head = branches(config)
    inputs = [x] if len(convs) == 1 else [x[:, 0:1], x[:, 1:2]]
    feats = []
    for h, (prefix, widths) in zip(inputs, convs):
        for i in range(len(widths) - 1):
            args = (w, f"{prefix}.{4 * i}", bn, precision, slope, eps, bn_stats)
            if recompute:
                h = checkpoint(_conv_block, h, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = _conv_block(h, *args)
        feats.append(h)
    h = torch.cat(feats, dim=1).flatten(1)
    p = config["dropout"]
    for n, lin in enumerate((1, 5)):
        h = _op(F.linear(_op(h, precision), _op(w[f"{head}.{lin}.weight"], precision),
                         w[f"{head}.{lin}.bias"]), precision)
        h = F.leaky_relu(_batch_norm(h, w, f"{head}.{lin + 1}", bn, eps, bn_stats), slope)
        if dropout_masks is not None:
            h = h * dropout_masks[n] / (1.0 - p)
    out = F.linear(_op(h, precision), _op(w[f"{head}.9.weight"], precision),
                   w[f"{head}.9.bias"])[:, 0]
    if config["variant"] == "double":
        out = torch.sigmoid(out) * 0.5
    return out


@torch.no_grad()
def predict(config: dict, w: Weights, raw: torch.Tensor, rows: int = 128,
            precision: str = "f32") -> torch.Tensor:
    """Eval-mode predictions of ``raw`` (on ``w``'s device), ``rows`` at a
    time -> (B,) float32 on that device."""
    out = [forward(config, w, raw[i:i + rows], precision=precision)
           for i in range(0, raw.shape[0], rows)]
    return torch.cat(out)
