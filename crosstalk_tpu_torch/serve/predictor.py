"""The fixed-shape predict function behind the server (port of
crosstalk_tpu/serve/predictor.py).

Normalization and the forward run on the device for a fixed set of batch
sizes (the batcher pads every flush to one of them). The forward is the
folded-BN bf16 path by default (``eval/fast_forward.py``, with block 0 in
the fused CUDA input-block kernel on the card), the opt-in int8 tier
(``eval/int8_forward.py``, block 0 in the same kernel), or the float32
``nn.Module`` with TF32 off for checkpoint-parity serving.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics
from crosstalk_tpu_torch.io.export import make_forward
from crosstalk_tpu_torch.io.torch_convert import StateDict


def make_predictor(
    state_dict: StateDict,
    model_cfg: ModelConfig,
    batch_size,
    image_size: int = 256,
    fast: bool = True,
    input_dtype=np.float32,
    device="cuda",
    warmup: bool = True,
    int8_scales=None,
) -> Callable[[np.ndarray], np.ndarray]:
    """-> fn((n, H, W, 2) ``input_dtype`` np) -> (n,) float32 np.

    ``batch_size`` is one int or a sequence of ints (batch buckets); ``n``
    must be one of them. ``fast`` selects the folded-BN bf16 forward;
    False runs the ``nn.Module`` in the config's compute dtype.
    ``input_dtype=np.float16`` takes float16 batches and upcasts them on
    the device, so the host-to-device copy moves half the bytes;
    normalization still runs in float32. ``device`` is ``'cuda'`` (the
    default; raises without a card) or ``'cpu'``. ``int8_scales`` (from
    ``eval.int8_forward.calibrate_int8``) serves the opt-in int8 tier; it
    requires ``fast`` and is OUTSIDE the 1e-4 parity budget.

    With ``warmup`` every bucket runs once, largest first, before this
    returns: on the card that builds and loads the input-block kernel on the
    calling thread, so the batcher's dispatcher thread never builds it.
    ``predict`` enters inference mode itself: the dispatcher thread does not
    inherit the caller's.
    """
    device = resolve_device(device)
    set_parity_numerics()
    input_dtype = np.dtype(input_dtype)
    if isinstance(batch_size, (list, tuple, set, frozenset)):
        sizes = tuple(sorted({int(b) for b in batch_size}))
    else:
        sizes = (int(batch_size),)
    if not sizes or sizes[0] <= 0:
        raise ValueError(f"batch sizes must be positive, got {sizes}")
    forward = make_forward(model_cfg, state_dict, fast=fast,
                           image_size=image_size, device=device,
                           int8_scales=int8_scales)
    shape = (image_size, image_size, 2)

    @torch.inference_mode()
    def predict(raw: np.ndarray) -> np.ndarray:
        if raw.ndim != 4 or raw.shape[1:] != shape or raw.shape[0] not in sizes:
            raise ValueError(
                f"predict expects shape (n, {', '.join(map(str, shape))}) "
                f"with n in {list(sizes)}, got {raw.shape}"
            )
        x = torch.from_numpy(np.ascontiguousarray(raw, input_dtype)).to(device)
        return forward(x.float()).cpu().numpy()

    if warmup:
        for b in reversed(sizes):
            predict(np.zeros((b,) + shape, input_dtype))
    return predict
