"""SwinV2-B as a regressor on the port's (B, 2, H, W) tiles.

Swin Transformer V2 (Liu et al., arXiv:2111.09883; microsoft/Swin-Transformer
``configs/swinv2/swinv2_base_patch4_window8_256.yaml``, timm's
``swinv2_base_window8_256``): patch 4, embed 128, depths 2-2-18-2, heads
4-8-16-32 (head dim 32), window 8, MLP ratio 4, q and v biases but no k
bias, drop path 0 -> 0.5 over the 24 blocks. Departures from the published
model: 2 input channels, a 1-output regression head, and no pretrained
weights (the optimizer, Adam with coupled L2, is the train step's).

* Patch embed: conv 4x4 stride 4, then LayerNorm.
* Block (residual post-norm): ``x = x + DP(LN1(WA(x)))``, then
  ``x = x + DP(LN2(MLP(x)))``, MLP 4C with GELU.
* Window attention: ``qkv = x W + [q_bias, 0, v_bias]``; q and k
  L2-normalised over the head dimension; logits
  ``q^ k^T * exp(min(tau_h, ln 100))`` plus ``16 sigmoid(CPB)[index]`` and,
  in shifted blocks, the -100 region mask; softmax, ``V`` and a projection.
* CPB: Linear(2, 512), ReLU, Linear(512, heads) without bias, over the
  (2w - 1)^2 relative coordinates, each divided by w - 1, times 8, then
  ``sign(x) log2(|x| + 1) / log2(8)``.
* Shift w/2 in odd blocks; a stage whose map is no larger than the window
  takes the map as its window and no shift.
* Patch merging: 2x2 concat to 4C, Linear(4C, 2C) without bias,
  LayerNorm(2C). Head: LayerNorm, mean over tokens, Linear(C, 1).

Each stage builds its tables once, at construction, on the model's device,
as non-persistent buffers: the coordinate table, the relative-position
index, the region mask where the stage shifts, and the token permutations
between its layouts. A forward makes no
tensor on the host and reads nothing back: partition, reverse and shift
are one gather of the tokens per block (``TokenPermute``, by a
precomputed permutation; the tokens stay in the running block's window
layout). The attention is ``F.scaled_dot_product_attention`` with the
position bias and region mask as its float mask (whose gradient reaches the
CPB) and the logit scale folded into q: on the card it ran the step faster
and in less memory than matmul, softmax, matmul (PERF.md). The drop-path
masks of a forward are one draw (``layers.SeededDropPath``).

Counters the tests read (``.value``): ``cpb_evaluations`` and
``window_attention_calls`` (one each per block and forward),
``tables_built`` (one per stage built).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.nn.functional as F
from torch import nn

from crosstalk_tpu_torch.models.layers import SeededDropPath

LOGIT_SCALE_MAX = math.log(100.0)
MASK_VALUE = -100.0
WINDOW_ATTENTION_RANGE = "crosstalk.swin.window_attention"
_NO_RANGE = contextlib.nullcontext()
# rms_norm(t, eps) / sqrt(d) = t / sqrt(|t|^2 + d eps): the published
# t / max(|t|, 1e-12) wherever |t| is not ~0
NORM_EPS = 1e-12


class Counter:
    """A count the tests read, safe to add to from several threads."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


cpb_evaluations = Counter()
window_attention_calls = Counter()
tables_built = Counter()


def coords_table(window: int, device=None) -> torch.Tensor:
    """-> ((2w - 1)^2, 2) float32: the log-spaced relative coordinates
    (dy, dx) that the CPB MLP reads, row-major over dy then dx."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32, device=device)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)
    t = t / (window - 1) * 8
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)
    return t.reshape(-1, 2)


def relative_index(window: int, device=None) -> torch.Tensor:
    """-> (w^2 * w^2,) int64: the row of ``coords_table`` for each pair
    (query token, key token) of a window, flattened."""
    c = torch.arange(window, device=device)
    pos = torch.stack(torch.meshgrid(c, c, indexing="ij")).flatten(1)  # (2, N)
    rel = (pos[:, :, None] - pos[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1)


def region_mask(side: int, window: int, shift: int, device=None) -> torch.Tensor:
    """-> (nW, N, N) float32: 0 between tokens of one region of the shifted
    map, -100 across regions (the published rule)."""
    img = torch.zeros(side, side, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for n, (h, w) in enumerate((h, w) for h in cuts for w in cuts):
        img[h, w] = n
    wins = img.view(side // window, window, side // window, window).permute(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def window_order(side: int, window: int, shift: int) -> torch.Tensor:
    """-> (side^2,) int64: the row-major map index of the token at each
    position of the windowed layout (windows row-major, tokens row-major
    within a window) of the map rolled by (-shift, -shift)."""
    n = side // window
    w = torch.arange(n).view(n, 1) * window
    t = torch.arange(window).view(1, window)
    line = ((w + t + shift) % side).view(n, 1, window, 1)
    return (line * side + line.view(1, n, 1, window)).reshape(-1)


def merge_order(side: int) -> torch.Tensor:
    """-> (side^2,) int64: map indices in groups of four per merged token
    (row-major over the merged map), each group the 2x2 neighbours in the
    published order (0, 0), (1, 0), (0, 1), (1, 1)."""
    half = torch.arange(side // 2)
    r, c = torch.meshgrid(2 * half, 2 * half, indexing="ij")
    quad = [(r, c), (r + 1, c), (r, c + 1), (r + 1, c + 1)]
    return torch.stack([y * side + x for y, x in quad], dim=-1).reshape(-1)


class TokenPermute(torch.autograd.Function):
    """``x[:, perm]`` on (B, L, C) tokens, one gather each way: the
    backward gathers the gradient with the inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, perm)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad.index_select(1, inverse), None, None


class WindowAttention(nn.Module):
    """Scaled cosine attention in windows with the continuous position bias.
    It holds its CPB MLP (``cpb_mlp``, the published layout) and logit
    scales; ``SwinStage.attention_inputs`` evaluates every block's at once."""

    def __init__(self, dim: int, heads: int, cpb_hidden: int = 512, device=None):
        super().__init__()
        self.heads = heads
        self.logit_scale = nn.Parameter(
            torch.full((heads, 1, 1), math.log(10.0), device=device))
        self.cpb_mlp = nn.Sequential(
            nn.Linear(2, cpb_hidden, device=device), nn.ReLU(inplace=True),
            nn.Linear(cpb_hidden, heads, bias=False, device=device))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("k_bias", torch.zeros(dim, device=device), persistent=False)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """x: (B * nW, N, C) windows, tile-major; ``bias`` (1, heads, N, N),
        or (1, nW * heads, N, N) with the region mask; ``scale`` (heads,
        1, 1): the block's logit scale. Both from ``SwinStage``."""
        window_attention_calls.add()
        bw, n, c = x.shape
        h, d = self.heads, c // self.heads
        qkv = F.linear(x, self.qkv.weight, torch.cat((self.q_bias, self.k_bias, self.v_bias)))
        q, k, v = qkv.view(bw, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        # normalize(t) = rms_norm(t) / sqrt(d): the two 1 / sqrt(d) go into
        # the product's scale, the per-head logit scale into q
        q = F.rms_norm(q, (d,), eps=NORM_EPS) * scale
        k = F.rms_norm(k, (d,), eps=NORM_EPS)
        if bias.shape[1] != h:
            # tile b's windows are rows b * nW .. b * nW + nW - 1: fold them
            # into the heads, so the (nW, heads) bias broadcasts over tiles
            hw = bias.shape[1]
            q, k, v = (t.reshape(bw * h // hw, hw, n, d) for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0 / d)
        out = out.reshape(bw, h, n, d).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def _residual(x: torch.Tensor, y: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """``x + y``, each tile's ``y`` times its (B, 1, 1) drop-path mask where
    given."""
    return x + y if keep is None else torch.addcmul(x, y, keep)


class SwinBlock(nn.Module):
    """One block on (B, L, C) tokens already in its window layout."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 cpb_hidden: int, eps: float, device=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.attn = WindowAttention(dim, heads, cpb_hidden, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.norm2 = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor, bias, scale, keep=None) -> torch.Tensor:
        """``bias``, ``scale``: the attention's (``SwinStage``); ``keep``:
        None, or this block's (attention, MLP) drop-path masks, (2, B, 1, 1)."""
        b, length, c = x.shape
        with _attention_range():
            y = self.attn(x.view(-1, self.window ** 2, c), bias, scale)
        x = _residual(x, self.norm1(y).view(b, length, c), None if keep is None else keep[0])
        return _residual(x, self.norm2(self.mlp(x)), None if keep is None else keep[1])


class PatchMerging(nn.Module):
    """2x2 concat (tokens already grouped by four), Linear(4C, 2C) without
    bias, LayerNorm(2C)."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)
        self.norm = nn.LayerNorm(2 * dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        return self.norm(self.reduction(x.view(b, length // 4, 4 * c)))


class SwinStage(nn.Module):
    """The blocks of one resolution, then the merge (all stages but the
    last), on (B, L, C) tokens that enter row-major over the map.

    The tokens stay in the layout of the block that runs: before each block
    one gather (``TokenPermute``) takes them from the last layout to that
    block's windows (plain, or of the rolled map), and before the merge to
    groups of four. The tables are built here, once, on the model's device:
    the coordinate table, the relative-position index, the region mask of
    the shifted blocks and the gathers with their inverses."""

    def __init__(self, dim: int, side: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, cpb_hidden: int, eps: float, merge: bool, device=None):
        super().__init__()
        win = min(window, side)
        shift = window // 2 if side > window else 0
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, win, shift if i % 2 else 0, mlp_ratio, cpb_hidden, eps,
                      device=device)
            for i in range(depth))
        self.downsample = PatchMerging(dim, eps, device=device) if merge else None
        if device == "meta":
            device = None  # the tables are not state: build them for real
        self.register_buffer("coords", coords_table(win, device), persistent=False)
        self.register_buffer("index", relative_index(win, device), persistent=False)
        self.register_buffer("mask", region_mask(side, win, shift, device) if shift
                             else None, persistent=False)
        # layouts: map index of the token at each position
        layouts = {"map": torch.arange(side * side), "plain": window_order(side, win, 0),
                   "shift": window_order(side, win, shift)}
        if merge:
            layouts["merge"] = merge_order(side)
        self.steps = []  # (buffer name, or None where the layout is unchanged)
        at = "map"
        for want in [("shift" if b.shift else "plain") for b in self.blocks] + (
                ["merge"] if merge else []):
            name = None
            if not torch.equal(layouts[at], layouts[want]):
                name = f"to_{want}_from_{at}"
                if not hasattr(self, name):
                    inv_at = torch.argsort(layouts[at])
                    perm = inv_at[layouts[want]]
                    self.register_buffer(name, perm.to(device), persistent=False)
                    self.register_buffer(name + "_inv", torch.argsort(perm).to(device),
                                         persistent=False)
            self.steps.append(name)
            at = want
        tables_built.add()

    def _gather(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        if name is None:
            return x
        return TokenPermute.apply(x, getattr(self, name), getattr(self, name + "_inv"))

    def attention_inputs(self):
        """-> ((depth, 1, heads', N, N) biases, (depth, heads, 1, 1) logit
        scales): every block's CPB MLP on the stage's 225 rows at once
        (stacked weights, float32 whatever the autocast), gathered to
        ``16 sigmoid(CPB)[index]``, the region mask added for the shifted
        blocks (heads' = nW x heads); the scales ``exp(min(tau, ln 100))``.
        Under autocast both come in its type, as the attention takes them."""
        attns = [blk.attn for blk in self.blocks]
        cpb_evaluations.add(len(attns))
        dev = self.coords.device.type
        with torch.autocast(dev, enabled=False):
            w1 = torch.stack([a.cpb_mlp[0].weight for a in attns]).transpose(1, 2)
            b1 = torch.stack([a.cpb_mlp[0].bias for a in attns]).unsqueeze(1)
            w2 = torch.stack([a.cpb_mlp[2].weight for a in attns]).transpose(1, 2)
            hid = torch.relu(torch.baddbmm(b1, self.coords.expand(len(attns), -1, -1), w1))
            table = 16 * torch.sigmoid(torch.bmm(hid, w2))  # (depth, (2w-1)^2, heads)
            tau = torch.stack([a.logit_scale for a in attns])
        depth, _, h = table.shape
        n = self.blocks[0].window ** 2
        bias = table.transpose(1, 2).index_select(2, self.index).view(depth, 1, h, n, n)
        scale = torch.clamp(tau, max=LOGIT_SCALE_MAX).exp()
        shifted = None
        if self.mask is not None:
            nw = self.mask.shape[0]
            shifted = (bias[1::2] + self.mask.unsqueeze(1)).view(-1, 1, nw * h, n, n)
        if torch.is_autocast_enabled(dev):
            low = torch.get_autocast_dtype(dev)
            bias, scale = bias.to(low), scale.to(low)
            shifted = None if shifted is None else shifted.to(low)
        if shifted is None:
            return bias, scale
        return [shifted[i // 2] if i % 2 else bias[i] for i in range(depth)], scale

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        """``keep``: None, or (2 x depth, B, 1, 1) drop-path masks, two a
        block."""
        bias, scale = self.attention_inputs()
        for i, blk in enumerate(self.blocks):
            x = blk(self._gather(x, self.steps[i]), bias[i], scale[i],
                    None if keep is None else keep[2 * i:2 * i + 2])
        if self.downsample is None:
            return x
        return self.downsample(self._gather(x, self.steps[-1]))


class SwinV2Regressor(nn.Module):
    variant = "swinv2-b"  # models.registry.build_model's name for it

    def __init__(self, input_channels: int = 2, image_size: int = 256, patch: int = 4,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (4, 8, 16, 32), window: int = 8,
                 mlp_ratio: float = 4.0, drop_path: float = 0.5, cpb_hidden: int = 512,
                 eps: float = 1e-5, device=None):
        super().__init__()
        side = image_size // patch
        if image_size % patch or side % (2 ** (len(depths) - 1)) or \
                side >> (len(depths) - 1) < 2:
            raise ValueError(
                f"swinv2: image size {image_size} must be a multiple of patch {patch} x "
                f"{2 ** (len(depths) - 1)} with a last stage of at least 2 x 2 tokens")
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(input_channels, embed_dim, patch, patch,
                                          device=device)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=eps, device=device)
        stages, dim = [], embed_dim
        for i, (depth, h) in enumerate(zip(depths, heads)):
            stages.append(SwinStage(dim, side, depth, h, window, mlp_ratio, cpb_hidden, eps,
                                    merge=i < len(depths) - 1, device=device))
            if i < len(depths) - 1:
                dim, side = dim * 2, side // 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=eps, device=device)
        self.head = nn.Linear(dim, 1, device=device)
        # block i's rate, i / (blocks - 1) of ``drop_path``, on its two residuals
        rates = torch.linspace(0, drop_path, sum(depths)).repeat_interleave(2)
        self.drop_path = SeededDropPath(rates.tolist(), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, 1)."""
        b = x.shape[0]
        keep = self.drop_path(b)
        keep = None if keep is None else keep.view(-1, b, 1, 1)
        x = self.patch_embed.norm(self.patch_embed.proj(x).flatten(2).transpose(1, 2))
        at = 0
        for stage in self.layers:
            n = 2 * len(stage.blocks)
            x = stage(x, None if keep is None else keep[at:at + n])
            at += n
        return self.head(self.norm(x).mean(dim=1))


def _attention_range():
    """``record_function(WINDOW_ATTENTION_RANGE)`` while a profiler runs, as
    ``utils.profiling.span`` enters its ranges; a shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    return torch.profiler.record_function(WINDOW_ATTENTION_RANGE)
