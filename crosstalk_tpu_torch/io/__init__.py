"""Checkpoints (``.pth`` and resume), run-directory artifacts and the
serving artifact.

The JAX package's names, less ``torch_to_flax`` and ``flax_to_torch``: the
port's models load a ``.pth`` natively, and ``torch_convert.
from_jax_variables`` carries JAX variables into a ``state_dict``.
"""

from crosstalk_tpu_torch.io.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    read_checkpoint_meta,
    save_checkpoint,
)
from crosstalk_tpu_torch.io.export import (
    export_serving_model,
    load_exported,
    read_exported,
    save_exported,
)
from crosstalk_tpu_torch.io.torch_convert import (
    image_size_compatible,
    infer_image_size,
    infer_model_size,
    load_pth,
    model_config_for_checkpoint,
    save_pth,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "read_checkpoint_meta",
    "AsyncCheckpointWriter",
    "load_pth",
    "save_pth",
    "image_size_compatible",
    "infer_image_size",
    "infer_model_size",
    "model_config_for_checkpoint",
    "export_serving_model",
    "save_exported",
    "read_exported",
    "load_exported",
]
