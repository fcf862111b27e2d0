"""Model FLOPs of SwinV2 (``reference/swinv2.py``) per tile, from shapes
alone, counted as ``flops.py`` counts the CNNs': 2 per multiply-add of the
dense layers and convolutions, the attention's two products included;
LayerNorms, softmax, activations, the position-bias MLP (its 225 rows a
block do not grow with the batch) and the element-wise work are not
counted. A train step counts 3 x the forward.

Per block of C channels over N tokens in windows of w^2 tokens:
2 x (12 C^2 N + 2 w^2 C N): qkv (3 C^2), the projection (C^2) and the MLP
(8 C^2) per token, and q k^T and attn v (w^2 C each) per token; at window 8
the second term is the 128 C N of the published count. Each patch merging
adds 2 x 4C x 2C per token after it, the embed 2 x p^2 x channels x C per
token, the head 2 x C.
"""

from __future__ import annotations

from benchmark.reference.swinv2 import stages


def forward_flops_per_tile(config: dict) -> int:
    p = config["patch_size"]
    side0 = config["image_size"] // p
    flops = 2 * side0 * side0 * p * p * config["input_channels"] * config["embed_dim"]
    for st in stages(config):
        c, n, w2 = st["dim"], st["side"] ** 2, st["window"] ** 2
        flops += st["depth"] * 2 * (12 * c * c * n + 2 * w2 * c * n)
        if st["merge"]:
            flops += 2 * (n // 4) * (4 * c) * (2 * c)
    return flops + 2 * stages(config)[-1]["dim"] * 2


def train_flops_per_tile(config: dict) -> int:
    return 3 * forward_flops_per_tile(config)
