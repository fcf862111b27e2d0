"""Model registry (port of crosstalk_tpu/models/registry.py): the CLI's
``-o single|double|swinv2-b`` flag resolves here (reference
train_model.py:534-537; ``swinv2-b`` is the port's own, models/swinv2.py)."""

from __future__ import annotations

import math

import torch
from torch import nn

from crosstalk_tpu_torch.config import VARIANTS, ModelConfig
from crosstalk_tpu_torch.models.single_branch import SingleBranchRegressor
from crosstalk_tpu_torch.models.swinv2 import SwinV2Regressor, WindowAttention
from crosstalk_tpu_torch.models.two_branch import TwoBranchRegressor


def build_model(cfg: ModelConfig, image_size: int = 256, device=None,
                process_group=None) -> nn.Module:
    """ModelConfig -> eval-mode ``nn.Module`` in the reference key schema.

    ``image_size`` sizes the first head Linear, as the reference's dummy
    forward does. ``device='meta'`` builds the module without storage.
    ``process_group`` (the JAX package's ``axis_name``) makes every
    BatchNorm cross-replica over its ranks in train mode; None (the
    default) builds ``layers.ChunkedBatchNorm2d`` (``nn.BatchNorm2d`` with a
    chunked backward past int32 indexing) and ``layers.OneRowBatchNorm1d``.
    ``swinv2-b`` has no BatchNorm and takes no group."""
    if cfg.variant == "swinv2-b":
        return SwinV2Regressor(
            input_channels=cfg.input_channels, image_size=image_size,
            patch=cfg.swin_patch, embed_dim=cfg.swin_embed_dim,
            depths=cfg.swin_depths, heads=cfg.swin_heads, window=cfg.swin_window,
            mlp_ratio=cfg.swin_mlp_ratio, drop_path=cfg.swin_drop_path,
            cpb_hidden=cfg.swin_cpb_hidden, eps=cfg.swin_ln_eps, device=device,
        ).eval()
    common = dict(
        image_size=image_size,
        leaky_slope=cfg.leaky_slope,
        bn_eps=cfg.bn_eps,
        bn_momentum=cfg.bn_momentum,
        device=device,
        process_group=process_group,
    )
    if cfg.variant == "double":
        model = TwoBranchRegressor(
            initial_filters_per_branch=cfg.initial_filters_per_branch,
            dropout=cfg.dropout_double,
            **common,
        )
    elif cfg.variant == "single":
        model = SingleBranchRegressor(
            input_channels=cfg.input_channels,
            initial_filters=cfg.initial_filters,
            num_conv_blocks=cfg.num_conv_blocks,
            max_filters=cfg.max_filters,
            dropout=cfg.dropout_single,
            **common,
        )
    else:
        raise ValueError(
            f"unknown model variant {cfg.variant!r} (use one of {', '.join(VARIANTS)})")
    return model.eval()


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every Conv2d/Linear weight, and its bias where it has one, from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with ``generator`` (torch's default
    Kaiming-uniform(a=sqrt(5)) and its bias init reduce to this bound), in
    module order. SwinV2's window attention then draws its q and v biases
    at the bound of its qkv layer and sets its logit scales to ln 10; its
    LayerNorms draw scales from U(0.8, 1.2) and shifts from U(-0.1, 0.1).
    The generator must live on the parameters' device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, WindowAttention):
            bound = 1.0 / math.sqrt(m.qkv.weight.shape[1])
            m.q_bias.uniform_(-bound, bound, generator=generator)
            m.v_bias.uniform_(-bound, bound, generator=generator)
            m.logit_scale.fill_(math.log(10.0))
        elif isinstance(m, nn.LayerNorm):
            m.weight.uniform_(0.8, 1.2, generator=generator)
            m.bias.uniform_(-0.1, 0.1, generator=generator)
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def architecture_summary(model: nn.Module) -> str:
    """``repr(model)``, then one line per parameter (its ``.pth`` key, shape
    and dtype) and the total: the layout of the JAX package's summary."""
    lines = [repr(model), "", "Parameters:"]
    for name, p in model.named_parameters():
        dtype = str(p.dtype).removeprefix("torch.")
        lines.append(f"  {name}: {tuple(p.shape)} {dtype}")
    lines.append(f"Total trainable parameters: {count_params(model):,}")
    return "\n".join(lines)


def torch_style_repr(cfg: ModelConfig, image_size: int = 256) -> str:
    """``str`` of the model, as written to model_architecture.txt."""
    return str(build_model(cfg, image_size=image_size, device="meta"))
