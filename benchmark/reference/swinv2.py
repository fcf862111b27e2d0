"""Plain float32 forward and train step of SwinV2-B as a regressor, written
from its published description (Liu et al., "Swin Transformer V2: Scaling Up
Capacity and Resolution", arXiv:2111.09883; microsoft/Swin-Transformer
``configs/swinv2/swinv2_base_patch4_window8_256.yaml`` and its
``models/swin_transformer_v2.py``) and nothing else.

* Patch embed: conv ``patch`` x ``patch`` stride ``patch``, LayerNorm.
* Four stages of ``depths`` blocks; block i of the whole model has drop
  path ``drop_path_rate * i / (blocks - 1)``. A block (residual post-norm):
  ``x = x + DP(LN1(WA(x)))``, ``x = x + DP(LN2(fc2(GELU(fc1(x)))))``.
* WA: windows of ``window`` x ``window`` tokens (the map's side where that
  is smaller, then without shift); odd blocks roll the map by -w/2 first
  and by +w/2 after. ``qkv = x Wqkv + [q_bias, 0, v_bias]``; per head,
  ``softmax(normalize(q) normalize(k)^T exp(min(tau, ln 100)) + 16
  sigmoid(CPB)[rel] + mask) v``, then ``proj``. CPB: Linear(2, 512), ReLU,
  Linear(512, heads) without bias, on each relative offset (dy, dx) of the
  window, each divided by w - 1, times 8, then ``sign log2(|t| + 1) / 3``.
  The mask is -100 between tokens of different regions of the rolled map
  (its last w and last w/2 rows and columns cut it into 3 x 3 regions).
* Stages 1-3 end in patch merging: the 2x2 neighbours (0,0), (1,0), (0,1),
  (1,1) concatenated, Linear(4C, 2C) without bias, LayerNorm(2C).
* Head: LayerNorm, mean over tokens, Linear(C, 1).

Departures from the published model: 2 input channels (the tile pair), a
1-output regression head, no pretrained weights, and the benchmark's
optimizer (Adam with coupled L2, as ``train.py``) in place of AdamW.

Weights are a dict in the program's key schema (``weight_shapes``). The
input is a raw (B, H, W, 2) batch, min-max normalized per (tile, channel)
and flipped as ``model.forward`` does. ``precision`` ``"fp8"`` rounds the
operands and outputs of every conv, dense layer and attention product to
e4m3 with a per-tensor scale (``model._op``): the control.

Drop-path masks (``drop_path_masks``): the step's generator, seeded as the
dropout's (``rules.dropout_masks``), makes one draw: ``bernoulli_`` of a
(2 x blocks, B) float32 tensor with the column of keep probabilities
``1 - rate``, rows in block order, the attention branch's then the MLP
branch's (a rate of 0 keeps every row).

This file imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import inputs
from benchmark.reference import rules
from benchmark.reference.model import _op, normalize, plain_numerics  # noqa: F401

Weights = Dict[str, torch.Tensor]
LOG100 = math.log(100.0)


def stages(config: dict) -> List[dict]:
    """-> per stage: ``dim``, ``side`` (tokens per side), ``heads``,
    ``window``, ``shift``, ``depth``, ``merge``."""
    side = config["image_size"] // config["patch_size"]
    dim, out = config["embed_dim"], []
    n = len(config["depths"])
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        win = min(config["window_size"], side)
        shift = config["window_size"] // 2 if side > config["window_size"] else 0
        out.append(dict(dim=dim, side=side, heads=heads, window=win, shift=shift,
                        depth=depth, merge=i < n - 1))
        dim, side = dim * 2, side // 2
    return out


def block_rates(config: dict) -> List[float]:
    """Block i's drop-path rate, as the published code draws them up:
    ``torch.linspace(0, drop_path_rate, blocks)``."""
    return torch.linspace(0, config["drop_path_rate"], sum(config["depths"])).tolist()


def weight_shapes(config: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """-> {key: (shape, kind)}; kind is ``dense`` (a conv or dense layer's
    weight or bias), ``qv`` (the attention's q and v biases), ``ln_w``,
    ``ln_b`` or ``tau``."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    c0, p = config["embed_dim"], config["patch_size"]
    out["patch_embed.proj.weight"] = ((c0, config["input_channels"], p, p), "dense")
    out["patch_embed.proj.bias"] = ((c0,), "dense")
    _ln_shapes(out, "patch_embed.norm", c0)
    hidden = config["cpb_hidden"]
    for s, st in enumerate(stages(config)):
        c, h = st["dim"], st["heads"]
        for b in range(st["depth"]):
            k = f"layers.{s}.blocks.{b}"
            out[f"{k}.attn.logit_scale"] = ((h, 1, 1), "tau")
            out[f"{k}.attn.q_bias"] = ((c,), "qv")
            out[f"{k}.attn.v_bias"] = ((c,), "qv")
            out[f"{k}.attn.cpb_mlp.0.weight"] = ((hidden, 2), "dense")
            out[f"{k}.attn.cpb_mlp.0.bias"] = ((hidden,), "dense")
            out[f"{k}.attn.cpb_mlp.2.weight"] = ((h, hidden), "dense")
            out[f"{k}.attn.qkv.weight"] = ((3 * c, c), "dense")
            out[f"{k}.attn.proj.weight"] = ((c, c), "dense")
            out[f"{k}.attn.proj.bias"] = ((c,), "dense")
            _ln_shapes(out, f"{k}.norm1", c)
            hid = int(c * config["mlp_ratio"])
            out[f"{k}.mlp.fc1.weight"] = ((hid, c), "dense")
            out[f"{k}.mlp.fc1.bias"] = ((hid,), "dense")
            out[f"{k}.mlp.fc2.weight"] = ((c, hid), "dense")
            out[f"{k}.mlp.fc2.bias"] = ((c,), "dense")
            _ln_shapes(out, f"{k}.norm2", c)
        if st["merge"]:
            out[f"layers.{s}.downsample.reduction.weight"] = ((2 * c, 4 * c), "dense")
            _ln_shapes(out, f"layers.{s}.downsample.norm", 2 * c)
    c = stages(config)[-1]["dim"]
    _ln_shapes(out, "norm", c)
    out["head.weight"] = ((1, c), "dense")
    out["head.bias"] = ((1,), "dense")
    return out


def _ln_shapes(out, key, n):
    out[f"{key}.weight"] = ((n,), "ln_w")
    out[f"{key}.bias"] = ((n,), "ln_b")


def trainable(config: dict) -> List[str]:
    return list(weight_shapes(config))


def make_weights(config: dict, seed: int, device) -> Weights:
    """-> the weights from ``seed``, drawn on ``device`` in one call as
    ``inputs.make_weights`` draws the CNNs': conv and dense weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), q and v biases at the bound
    of their qkv layer, LayerNorm scales U(0.8, 1.2) and shifts
    U(-0.1, 0.1), tau = ln 10."""
    shapes = weight_shapes(config)
    sizes = {k: int(torch.Size(s).numel()) for k, (s, _) in shapes.items()}
    g = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, "weights"))
    u = torch.rand(sum(sizes.values()), generator=g, device=device) * 2 - 1
    w, at = {}, 0
    for k, (shape, kind) in shapes.items():
        v = u[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if kind == "dense":
            fan_in = torch.Size(shapes[k.rsplit(".", 1)[0] + ".weight"][0][1:]).numel()
            v = v / fan_in ** 0.5
        elif kind == "qv":
            v = v / shape[0] ** 0.5
        elif kind == "ln_w":
            v = 1.0 + 0.2 * v
        elif kind == "ln_b":
            v = 0.1 * v
        else:
            v = torch.full(shape, math.log(10.0), device=device)
        w[k] = v.clone()
    return w


def coords_table(window: int, device) -> torch.Tensor:
    rows = []
    for dy in range(-(window - 1), window):
        for dx in range(-(window - 1), window):
            t = [8.0 * d / (window - 1) for d in (dy, dx)]
            rows.append([math.copysign(math.log2(abs(v) + 1.0) / 3.0, v) if v else 0.0
                         for v in t])
    return torch.tensor(rows, dtype=torch.float32, device=device)


def relative_index(window: int, device) -> torch.Tensor:
    pos = [(y, x) for y in range(window) for x in range(window)]
    idx = [(yi - yj + window - 1) * (2 * window - 1) + (xi - xj + window - 1)
           for yi, xi in pos for yj, xj in pos]
    return torch.tensor(idx, dtype=torch.int64, device=device)


def region_mask(side: int, window: int, shift: int, device) -> torch.Tensor:
    """-> (nW, N, N): 0 within a region of the rolled map, -100 across."""
    def band(i):
        return 0 if i < side - window else (1 if i < side - shift else 2)

    label = torch.tensor([[3 * band(y) + band(x) for x in range(side)] for y in range(side)],
                         dtype=torch.float32)
    n = side // window
    wins = label.view(n, window, n, window).permute(0, 2, 1, 3).reshape(n * n, -1)
    same = wins[:, :, None] == wins[:, None, :]
    return torch.where(same, 0.0, -100.0).to(device)


def drop_path_masks(config: dict, seed: int, step: int, rows: int, device
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """-> per block, its (attention, MLP) keep masks, (rows,) of 0 or 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(rules.counter_key(seed, step, rules.DROPOUT_STREAM, 0))
    keep = torch.tensor([1.0 - r for r in block_rates(config) for _ in range(2)],
                        device=device).view(-1, 1)
    m = torch.empty((keep.shape[0], rows), dtype=torch.float32, device=device)
    m.bernoulli_(keep, generator=gen)
    return [(m[2 * i], m[2 * i + 1]) for i in range(keep.shape[0] // 2)]


def _linear(x, w, key, precision):
    return _op(F.linear(_op(x, precision), _op(w[f"{key}.weight"], precision),
                        w.get(f"{key}.bias")), precision)


def _ln(x, w, key, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{key}.weight"], w[f"{key}.bias"], eps)


def _attention(x, w, k, st, tables, precision):
    """x: (B * nW, N, C) windows -> the same after attention."""
    bw, n, c = x.shape
    h = st["heads"]
    coords, index, mask = tables
    bias = torch.cat([w[f"{k}.q_bias"], torch.zeros_like(w[f"{k}.q_bias"]), w[f"{k}.v_bias"]])
    qkv = _op(F.linear(_op(x, precision), _op(w[f"{k}.qkv.weight"], precision), bias),
              precision)
    q, kk, v = qkv.view(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
    logits = _op(F.normalize(q, dim=-1), precision) @ \
        _op(F.normalize(kk, dim=-1), precision).transpose(-2, -1)
    logits = _op(logits, precision) * torch.clamp(w[f"{k}.logit_scale"], max=LOG100).exp()
    hid = F.relu(_linear(coords, w, f"{k}.cpb_mlp.0", precision))
    table = _linear(hid, w, f"{k}.cpb_mlp.2", precision)
    rel = 16 * torch.sigmoid(table[index].view(n, n, h).permute(2, 0, 1))
    logits = logits + rel
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.view(bw // nw, nw, h, n, n) + mask[None, :, None]).view(bw, h, n, n)
    out = _op(_op(torch.softmax(logits, dim=-1), precision) @ _op(v, precision), precision)
    return _linear(out.transpose(1, 2).reshape(bw, n, c), w, f"{k}.proj", precision)


def _block(x, w, k, st, shift, tables, masks, rate, eps, precision):
    b, side, _, c = x.shape
    win = st["window"]
    y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    nwin = side // win
    y = y.view(b, nwin, win, nwin, win, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
    y = _attention(y, w, f"{k}.attn", st, tables if shift else tables[:2] + (None,), precision)
    y = y.view(b, nwin, nwin, win, win, c).permute(0, 1, 3, 2, 4, 5).reshape(b, side, side, c)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))

    def dp(t, i):
        if masks is None:
            return t
        return t * (masks[i] / (1.0 - rate)).view(-1, 1, 1, 1)

    x = x + dp(_ln(y, w, f"{k}.norm1", eps), 0)
    hid = F.gelu(_linear(x, w, f"{k}.mlp.fc1", precision))
    return x + dp(_ln(_linear(hid, w, f"{k}.mlp.fc2", precision), w, f"{k}.norm2", eps), 1)


def forward(config: dict, w: Weights, raw: torch.Tensor, *, precision: str = "f32",
            drop_masks=None, flips: Optional[torch.Tensor] = None,
            recompute: bool = False) -> torch.Tensor:
    """Raw (B, H, W, 2) tiles -> (B,) predictions. ``drop_masks`` as
    ``drop_path_masks`` gives them (None: eval, no drop path);
    ``recompute`` recomputes each block in the backward."""
    eps = config["layer_norm_eps"]
    x = normalize(raw)
    if flips is not None:
        x = torch.where(flips[:, 0].view(-1, 1, 1, 1), x.flip(2), x)
        x = torch.where(flips[:, 1].view(-1, 1, 1, 1), x.flip(1), x)
    p = config["patch_size"]
    x = _op(F.conv2d(_op(x.permute(0, 3, 1, 2), precision),
                     _op(w["patch_embed.proj.weight"], precision),
                     w["patch_embed.proj.bias"], stride=p), precision)
    x = _ln(x.permute(0, 2, 3, 1), w, "patch_embed.norm", eps)
    rates, at = block_rates(config), 0
    for s, st in enumerate(stages(config)):
        dev = x.device
        tables = (coords_table(st["window"], dev), relative_index(st["window"], dev),
                  region_mask(st["side"], st["window"], st["shift"], dev)
                  if st["shift"] else None)
        for b in range(st["depth"]):
            shift = st["shift"] if b % 2 else 0
            masks = drop_masks[at] if drop_masks is not None else None
            args = (w, f"layers.{s}.blocks.{b}", st, shift, tables, masks, rates[at], eps,
                    precision)
            if recompute:
                x = checkpoint(_block, x, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = _block(x, *args)
            at += 1
        if st["merge"]:
            bsz, side, _, c = x.shape
            x = x.view(bsz, side // 2, 2, side // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
            x = x.reshape(bsz, side // 2, side // 2, 4 * c)
            x = _ln(_linear(x, w, f"layers.{s}.downsample.reduction", precision), w,
                    f"layers.{s}.downsample.norm", eps)
    x = _ln(x, w, "norm", eps).mean(dim=(1, 2))
    return F.linear(_op(x, precision), _op(w["head.weight"], precision), w["head.bias"])[:, 0]


class SwinReferenceTraining:
    """``train.ReferenceTraining`` for this model: parameters and Adam
    moments stepped by ``step``, the same update (Adam with coupled L2),
    no running statistics."""

    def __init__(self, config: dict, optim: dict, weights: Weights, precision: str = "f32",
                 t: int = 0, m: Optional[Weights] = None, v: Optional[Weights] = None):
        self.config, self.optim, self.precision = config, optim, precision
        self.keys = trainable(config)
        self.stat_keys: List[str] = []
        self.w = {k: weights[k].detach().clone() for k in self.keys}
        self.m = {k: (m[k].detach().clone() if m else torch.zeros_like(self.w[k]))
                  for k in self.keys}
        self.v = {k: (v[k].detach().clone() if v else torch.zeros_like(self.w[k]))
                  for k in self.keys}
        self.t = t
        self.last_grad: Weights = {}
        self.last_preds: Optional[torch.Tensor] = None

    def step(self, raw: torch.Tensor, labels: torch.Tensor, seed: int, lr: float) -> float:
        b = raw.shape[0]
        params = {k: self.w[k].requires_grad_(True) for k in self.keys}
        preds = forward(self.config, params, raw, precision=self.precision,
                        drop_masks=drop_path_masks(self.config, seed, self.t, b, raw.device),
                        flips=rules.flips(seed, self.t, b, raw.device), recompute=True)
        loss = F.mse_loss(preds, labels)
        grads = torch.autograd.grad(loss, [params[k] for k in self.keys])
        self.last_preds = preds.detach()
        o = self.optim
        self.t += 1
        c1 = 1 - o["adam_b1"] ** self.t
        c2 = math.sqrt(1 - o["adam_b2"] ** self.t)
        self.last_grad = {}
        with torch.no_grad():
            for k, g in zip(self.keys, grads):
                p = self.w[k].requires_grad_(False)
                self.last_grad[k] = g
                g = g + o["weight_decay"] * p
                self.m[k].mul_(o["adam_b1"]).add_(g, alpha=1 - o["adam_b1"])
                self.v[k].mul_(o["adam_b2"]).addcmul_(g, g, value=1 - o["adam_b2"])
                p.sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / c2 + o["adam_eps"]))
        return float(loss.detach())

    def first_moment_as_gradient(self) -> Weights:
        return {k: self.m[k] / (1 - self.optim["adam_b1"]) for k in self.keys}
