"""The serving semantics, defined once (port of ``make_forward`` in
crosstalk_tpu/io/export.py): per-tile min-max normalize, then the forward,
then the ``(B,)`` alphas. The online predictor (serve/predictor.py) and the
predict CLI build on it.

The JAX module's ``.ctkx`` export has no counterpart here yet; the port's
artifact (``torch.export``) is a later slice (ROADMAP).
"""

from __future__ import annotations

from typing import Callable

import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
from crosstalk_tpu_torch.io.torch_convert import StateDict


def make_forward(
    model_cfg: ModelConfig,
    state_dict: StateDict,
    fast: bool = True,
    image_size: int = 256,
    device="cpu",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """-> fn(raw (B, H, W, 2) float32 on ``device``) -> (B,) float32.

    ``fast`` runs the folded-BN bf16 forward (``eval/fast_forward.py``: the
    fused input-block kernel on block 0 when ``device`` is a card);
    otherwise the ``nn.Module`` in the config's compute dtype, sized for
    ``image_size`` tiles. The weights are moved to ``device`` once, here.
    """
    device = torch.device(device)
    if fast:
        from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward

        forward = make_fast_forward(
            model_cfg, {k: v.to(device) for k, v in state_dict.items()})
    else:
        from crosstalk_tpu_torch.eval.engine import model_forward
        from crosstalk_tpu_torch.models.registry import build_model

        model = build_model(model_cfg, image_size=image_size, device=device)
        model.load_state_dict(state_dict)
        forward = model_forward(model, model_cfg.compute_dtype)

    def serve(raw: torch.Tensor) -> torch.Tensor:
        return forward(normalize_batch_nhwc(raw))[:, 0].float()

    return serve
