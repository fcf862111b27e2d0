"""CrosstalkTPU on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``crosstalk_tpu`` that keeps its module names,
its ``.pth`` key schema, its run-directory artifacts and its numerics
budgets. The port imports nothing of the JAX package; the tests hold each
module against its JAX counterpart on the CPU.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card and without that request they raise (``device.resolve_device``).
The fused input block (``ops/input_block.py``) is a hand-written CUDA
kernel (``csrc/input_block.cu``) built with ``nvcc`` at first use.

The JAX package's top-level names resolve here on first use, e.g.
``crosstalk_tpu_torch.make_fast_forward``; importing the package alone
imports no torch.
"""

__version__ = "0.1.0"

# The JAX package's top-level names that the port has, resolved lazily so
# that ``import crosstalk_tpu_torch`` imports no torch until a name is used.
# Left out: ``torch_to_flax`` and ``flax_to_torch`` (the port's models load
# a ``.pth`` natively; ``io.torch_convert.from_jax_variables`` carries JAX
# variables across).
_PUBLIC_API = {
    # config
    "ModelConfig": "crosstalk_tpu_torch.config",
    "OptimConfig": "crosstalk_tpu_torch.config",
    "TrainConfig": "crosstalk_tpu_torch.config",
    # data
    "PairIndex": "crosstalk_tpu_torch.data",
    "Sample": "crosstalk_tpu_torch.data",
    "UnlabeledIndex": "crosstalk_tpu_torch.data",
    "pair_unlabeled": "crosstalk_tpu_torch.data",
    "split_samples": "crosstalk_tpu_torch.data",
    "read_tile": "crosstalk_tpu_torch.data",
    "TileStore": "crosstalk_tpu_torch.data",
    "DeviceDataset": "crosstalk_tpu_torch.data",
    "Batch": "crosstalk_tpu_torch.data",
    # models
    "build_model": "crosstalk_tpu_torch.models",
    "init_model": "crosstalk_tpu_torch.models",
    "count_params": "crosstalk_tpu_torch.models",
    "SingleBranchRegressor": "crosstalk_tpu_torch.models",
    "TwoBranchRegressor": "crosstalk_tpu_torch.models",
    # train
    "train_model": "crosstalk_tpu_torch.train",
    "TrainState": "crosstalk_tpu_torch.train",
    "init_train_state": "crosstalk_tpu_torch.train",
    "make_train_step": "crosstalk_tpu_torch.train",
    "make_val_step": "crosstalk_tpu_torch.train",
    "make_optimizer": "crosstalk_tpu_torch.train",
    # eval / serving
    "evaluate": "crosstalk_tpu_torch.eval",
    "evaluate_and_save": "crosstalk_tpu_torch.eval",
    "make_fast_forward": "crosstalk_tpu_torch.eval",
    # checkpoint / interop
    "save_checkpoint": "crosstalk_tpu_torch.io",
    "load_checkpoint": "crosstalk_tpu_torch.io",
    "read_checkpoint_meta": "crosstalk_tpu_torch.io",
    "load_pth": "crosstalk_tpu_torch.io",
    "save_pth": "crosstalk_tpu_torch.io",
    "export_serving_model": "crosstalk_tpu_torch.io",
    "load_exported": "crosstalk_tpu_torch.io",
}

__all__ = sorted(_PUBLIC_API) + ["__version__"]


def __getattr__(name: str):
    module = _PUBLIC_API.get(name)
    if module is None:
        raise AttributeError(f"module 'crosstalk_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
