"""Device selection and the numerics switches of the f32 parity mode."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: Optional[str] = "cuda") -> torch.device:
    """``'cuda'`` (the default, also for ``None``) or ``'cpu'`` -> a device.

    A CUDA request on a host without a usable card raises: the port never
    carries on quietly on the CPU. Only an explicit ``'cpu'`` runs there.
    """
    name = name or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r} (use 'cuda' or 'cpu')")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU explicitly"
        )
    return torch.device(name)


def device_label(device: torch.device) -> str:
    """``'cuda:<card name>'`` or ``'cpu'``, as the CLIs print and report it."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def set_parity_numerics() -> None:
    """Full-precision float32 on the card, as the JAX package's
    ``Precision.HIGHEST`` gives (crosstalk_tpu/models/registry.py:23-26).

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and breaks the <=1e-4 MAE budget of the f32 mode;
    matmuls default to full float32 but are set explicitly all the same.
    bf16 GEMMs must not reduce partial sums in bf16 (the JAX head keeps an
    f32 accumulator, eval/fast_forward.py:76-79).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
