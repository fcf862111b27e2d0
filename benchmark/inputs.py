"""What the benchmark hands to both the program and the reference, made
from ``--seed``: tiles with known alphas and the model's weights.

Tiles follow ``generate_pair`` of the published synthetic data set
(``mixed = other + alpha * source``; ``source`` and ``other`` are blocky
random fields of 8x8-pixel blobs plus 5% pixel noise; alpha uniform in
[0.01, 0.5], rounded to two decimals), drawn in bulk by a
``torch.Generator`` on the device asked for. Channel 0 is mixed, channel 1
source.

Weights are drawn on the device in one call: conv and dense weights and
biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default), the
BatchNorm scales from U(0.8, 1.2) and shifts from U(-2, -1) (the traffic
may set another range, ``bn_shift``). With
``calibration`` tiles the BatchNorm running statistics are their batch
statistics, so that every layer sees unit-scale activations in eval mode
and the predictions spread over a batch (with unit running statistics a
random full-width network gives nearly one value for every tile).

The negative shifts leave one unit in five to ten above zero after each
LeakyReLU, sparse as in trained ReLU networks. With dense unit-scale
activations an int8 grid fitted to each tensor is about as fine as
bfloat16's relative rounding, and the bfloat16 and int8 forwards land
within about 2x of each other from the float32 one; with sparse ones the
int8 grid is coarse against most values while bfloat16 keeps its relative
precision, so a drop from the one to the other shows (PERF.md).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import torch

from benchmark.reference import model


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each draw made from ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_tiles(seed: int, n: int, size: int, device, what: str = "tiles",
               block: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ((n, size, size, 2) float32 raw tiles, (n,) float32 alphas)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, what))
    alpha = torch.round(torch.rand(n, generator=g, device=device) * 49 + 1) / 100
    nb = -(-size // block)
    fields = torch.rand((2, n, nb, nb), generator=g, device=device)
    fields = fields.repeat_interleave(block, 2).repeat_interleave(block, 3)
    fields = fields[..., :size, :size] + 0.05 * torch.rand(
        (2, n, size, size), generator=g, device=device)
    source, other = fields[0], fields[1]
    tiles = torch.stack([other + alpha.view(n, 1, 1) * source, source], dim=-1)
    return tiles, alpha


def make_weights(config: dict, seed: int, device,
                 calibration: Optional[torch.Tensor] = None,
                 bn_shift: Tuple[float, float] = (-2.0, -1.0)) -> model.Weights:
    """-> the weights in the published ``.pth`` schema, float32 on
    ``device``, the BatchNorm shifts uniform in ``bn_shift``; the running
    statistics from ``calibration`` raw tiles when given (variance 1 and
    mean 0 otherwise)."""
    shapes = model.weight_shapes(config)
    sizes = {k: int(torch.Size(s).numel()) for k, (s, _) in shapes.items()}
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(sizes.values()), generator=g, device=device) * 2 - 1
    w, at = {}, 0
    for k, (shape, kind) in shapes.items():
        v = u[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if kind in ("conv", "linear"):
            base = k.rsplit(".", 1)[0]
            fan_in = torch.Size(shapes[f"{base}.weight"][0][1:]).numel()
            v = v / fan_in ** 0.5
        elif kind == "bn":
            lo, hi = bn_shift
            v = 1.0 + 0.2 * v if k.endswith("weight") else lo + (v + 1) * (hi - lo) / 2
        elif kind == "stat":
            v = torch.full(shape, 1.0 if k.endswith("var") else 0.0, device=device)
        else:
            v = torch.zeros((), dtype=torch.int64, device=device)
        w[k] = v.clone()
    del u
    if calibration is not None:
        with torch.no_grad():
            model.forward(config, w, calibration, bn=model.BatchNormMode.CALIBRATE)
    return w
