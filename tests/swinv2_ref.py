"""Plain float32 forward of SwinV2 as a regressor, from a weight dict, for
the CPU tests of ``crosstalk_tpu_torch/models/swinv2.py``.

Written from the published description (Liu et al., "Swin Transformer V2:
Scaling Up Capacity and Resolution", arXiv:2111.09883; microsoft/
Swin-Transformer ``models/swin_transformer_v2.py`` and
``configs/swinv2/swinv2_base_patch4_window8_256.yaml``): patch embed (conv
p x p stride p, LayerNorm); stages of residual post-norm blocks
``x = x + DP(LN1(WA(x)))``, ``x = x + DP(LN2(MLP(x)))``; window attention
``softmax(normalize(q) normalize(k)^T exp(min(tau, ln 100)) + 16
sigmoid(CPB)[rel] + mask) v`` with ``qkv = x W + [q_bias, 0, v_bias]``; a
shift of w/2 in odd blocks under the -100 region mask; a stage whose map is
no larger than the window takes the map as its window and no shift;
patch merging (2x2 concat, Linear(4C, 2C) without bias, LayerNorm); head
LayerNorm, mean over tokens, Linear(C, 1).

Departures from the published model, each the port's: 2 input channels, a
1-output regression head, no pretrained weights (and, in training, Adam
with coupled L2 in place of AdamW). Everything is computed with loops and
plain tensor ops in float32, TF32 off (``plain_numerics``).

Imports nothing of JAX or of either package under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def plain_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def stages(image: int, patch: int, embed: int, depths: Sequence[int],
           heads: Sequence[int], window: int) -> List[dict]:
    side, dim, out = image // patch, embed, []
    for i, (depth, h) in enumerate(zip(depths, heads)):
        out.append(dict(dim=dim, side=side, heads=h, window=min(window, side),
                        shift=window // 2 if side > window else 0, depth=depth,
                        merge=i < len(depths) - 1))
        dim, side = dim * 2, side // 2
    return out


def drop_rates(depths: Sequence[int], rate: float) -> List[float]:
    """Block i's drop-path rate, as the published code draws them up."""
    return torch.linspace(0, rate, sum(depths)).tolist()


def coords_table(window: int) -> torch.Tensor:
    """((2w - 1)^2, 2): (dy, dx) / (w - 1) * 8, then sign log2(|t| + 1) / 3."""
    rows = []
    for dy in range(-(window - 1), window):
        for dx in range(-(window - 1), window):
            t = [8.0 * d / (window - 1) for d in (dy, dx)]
            rows.append([math.copysign(math.log2(abs(v) + 1.0) / math.log2(8), v)
                         for v in t])
    return torch.tensor(rows, dtype=torch.float32)


def relative_index(window: int) -> torch.Tensor:
    pos = [(y, x) for y in range(window) for x in range(window)]
    return torch.tensor([(yi - yj + window - 1) * (2 * window - 1) + (xi - xj + window - 1)
                         for yi, xi in pos for yj, xj in pos])


def region_mask(side: int, window: int, shift: int) -> torch.Tensor:
    """(nW, N, N): 0 within a region of the rolled map, -100 across; the
    rows and columns [0, side - w), [side - w, side - shift) and
    [side - shift, side) make 3 x 3 regions."""
    def band(i):
        return 0 if i < side - window else (1 if i < side - shift else 2)

    wins = []
    for wy in range(side // window):
        for wx in range(side // window):
            wins.append([3 * band(wy * window + y) + band(wx * window + x)
                         for y in range(window) for x in range(window)])
    lab = torch.tensor(wins)
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, -100.0)


def _ln(x, w, key, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{key}.weight"], w[f"{key}.bias"], eps)


def _attention(x, w, k, heads, window, mask):
    bw, n, c = x.shape
    qb = w[f"{k}.q_bias"]
    qkv = F.linear(x, w[f"{k}.qkv.weight"], torch.cat([qb, torch.zeros_like(qb), w[f"{k}.v_bias"]]))
    q, kk, v = qkv.view(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    logits = F.normalize(q, dim=-1) @ F.normalize(kk, dim=-1).transpose(-2, -1)
    logits = logits * torch.clamp(w[f"{k}.logit_scale"], max=math.log(100.0)).exp()
    table = F.linear(F.relu(F.linear(coords_table(window).to(x.device),
                                     w[f"{k}.cpb_mlp.0.weight"], w[f"{k}.cpb_mlp.0.bias"])),
                     w[f"{k}.cpb_mlp.2.weight"])
    rel = table[relative_index(window).to(x.device)].view(n, n, heads).permute(2, 0, 1)
    logits = logits + 16 * torch.sigmoid(rel)
    if mask is not None:
        nw = mask.shape[0]
        logits = logits.view(bw // nw, nw, heads, n, n) + mask[None, :, None].to(x.device)
        logits = logits.view(bw, heads, n, n)
    out = torch.softmax(logits, dim=-1) @ v
    return F.linear(out.transpose(1, 2).reshape(bw, n, c), w[f"{k}.proj.weight"],
                    w[f"{k}.proj.bias"])


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, *, image: int, patch: int = 4,
            embed: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
            heads: Sequence[int] = (4, 8, 16, 32), window: int = 8, drop_path: float = 0.5,
            eps: float = 1e-5,
            masks: Optional[List[Optional[Tuple[torch.Tensor, torch.Tensor]]]] = None
            ) -> torch.Tensor:
    """Normalized (B, 2, H, W) -> (B, 1). ``masks``: per block, None or its
    (attention, MLP) drop-path keep masks, (B,) each; None: no drop path."""
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=patch)
    x = _ln(x.permute(0, 2, 3, 1), w, "patch_embed.norm", eps)
    rates, at = drop_rates(depths, drop_path), 0
    for s, st in enumerate(stages(image, patch, embed, depths, heads, window)):
        win, side, c = st["window"], st["side"], st["dim"]
        nwin = side // win
        for b in range(st["depth"]):
            k = f"layers.{s}.blocks.{b}"
            shift = st["shift"] if b % 2 else 0
            bsz = x.shape[0]
            y = torch.roll(x, (-shift, -shift), (1, 2))
            y = y.view(bsz, nwin, win, nwin, win, c).permute(0, 1, 3, 2, 4, 5)
            y = _attention(y.reshape(-1, win * win, c), w, f"{k}.attn", st["heads"], win,
                           region_mask(side, win, shift) if shift else None)
            y = y.view(bsz, nwin, nwin, win, win, c).permute(0, 1, 3, 2, 4, 5)
            y = torch.roll(y.reshape(bsz, side, side, c), (shift, shift), (1, 2))
            m = masks[at] if masks is not None else None
            keep = 1.0 - rates[at]

            def dp(t, i):
                return t if m is None else t * (m[i] / keep).view(-1, 1, 1, 1)

            x = x + dp(_ln(y, w, f"{k}.norm1", eps), 0)
            hid = F.gelu(F.linear(x, w[f"{k}.mlp.fc1.weight"], w[f"{k}.mlp.fc1.bias"]))
            mlp = F.linear(hid, w[f"{k}.mlp.fc2.weight"], w[f"{k}.mlp.fc2.bias"])
            x = x + dp(_ln(mlp, w, f"{k}.norm2", eps), 1)
            at += 1
        if st["merge"]:
            bsz = x.shape[0]
            parts = [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]]
            x = F.linear(torch.cat(parts, dim=-1), w[f"layers.{s}.downsample.reduction.weight"])
            x = _ln(x, w, f"layers.{s}.downsample.norm", eps)
    x = _ln(x, w, "norm", eps).mean(dim=(1, 2))
    return F.linear(x, w["head.weight"], w["head.bias"])
