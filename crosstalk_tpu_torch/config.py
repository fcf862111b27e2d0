"""Configuration dataclasses: the port's own copy of the JAX package's
``crosstalk_tpu/config.py`` (``ModelConfig``, ``OptimConfig``,
``TrainConfig`` and the scheduler tables, with the same defaults), so that
the port imports nothing of that package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


VARIANTS = ("single", "double", "swinv2-b")
# the conv/BatchNorm family, which the --fast and int8 tiers and the JAX
# package's formats know
CNN_VARIANTS = ("single", "double")


def require_cnn(variant: str, what: str) -> None:
    """Raise ValueError naming ``variant`` where ``what``, a path of the
    conv/BatchNorm models alone, cannot run it."""
    if variant not in CNN_VARIANTS:
        raise ValueError(f"{what} runs the conv/BatchNorm models only "
                         f"({', '.join(CNN_VARIANTS)}), not {variant!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Instantiated model configs (reference train_model.py:534-537).

    'single' -> AdvancedRegressionModel(initial_filters=128, num_conv_blocks=6)
    'double' -> SimplifiedTwoBranchRegressionModel(initial_filters_per_branch=64)
    'swinv2-b' -> SwinV2-B at window 8 (models/swinv2.py; the swin_* sizes)
    """

    variant: str = "single"       # 'single' | 'double' | 'swinv2-b'
    input_channels: int = 2
    initial_filters: int = 128    # single-branch width
    num_conv_blocks: int = 6      # single-branch depth
    max_filters: int = 512        # channel doubling cap (regression_model.py:22)
    initial_filters_per_branch: int = 64   # two-branch width
    leaky_slope: float = 0.01
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1      # torch convention: new = (1-m)*old + m*batch
    dropout_single: float = 0.1   # regression_model.py:39,44
    dropout_double: float = 0.5   # two_branch_regression.py:45,50
    # 'f32' is the <=1e-4 MAE parity mode (TF32 off, see device.py);
    # 'bf16' runs the nn.Module forward under bf16 autocast.
    compute_dtype: str = "bf16"
    # SwinV2-B (configs/swinv2/swinv2_base_patch4_window8_256.yaml)
    swin_patch: int = 4
    swin_embed_dim: int = 128
    swin_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin_window: int = 8
    swin_mlp_ratio: float = 4.0
    swin_drop_path: float = 0.5
    swin_cpb_hidden: int = 512
    swin_ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer + scheduler settings (reference train_model.py:330-366, 636-637)."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4    # L2 coupled into the gradient (torch Adam), not AdamW
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    scheduler: str = "aggressive_plateau"  # | 'onecycle' | 'cosine_warmup'

    # aggressive_plateau (train_model.py:331-340)
    plateau_factor: float = 0.3
    plateau_patience: int = 3
    plateau_threshold: float = 5e-5
    plateau_min_lr: float = 1e-8

    # onecycle (train_model.py:342-354) — max_lr overrides the CLI lr,
    # exactly as the reference does.
    onecycle_max_lr: float = 1e-3
    onecycle_pct_start: float = 0.3
    onecycle_div_factor: float = 25.0
    onecycle_final_div_factor: float = 1e4

    # cosine_warmup (train_model.py:356-365). The reference's variant is
    # broken (config type 'custom_warmup' is never constructed and stepping it
    # raises NameError at the end of epoch 1 — train_model.py:376-387,451-452).
    # This is the schedule its parameters describe: linear warmup for
    # warmup_epochs to max_lr, then cosine decay to final_lr.
    warmup_epochs: int = 5
    warmup_max_lr: float = 1e-4
    warmup_final_lr: float = 1e-7


# Early-stop patience per scheduler (train_model.py:339, 353, 364).
EARLY_STOP_PATIENCE = {
    "aggressive_plateau": 8,
    "onecycle": 20,
    "cosine_warmup": 15,
}

# Scheduler registry "type" strings, used in artifact filenames
# (train_model.py:331, 343, 357 — e.g. best_model_plateau.pth).
SCHEDULER_TYPE_NAMES = {
    "aggressive_plateau": "plateau",
    "onecycle": "onecycle",
    "cosine_warmup": "custom_warmup",
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    num_epochs: int = 50
    output_base: str = "."
    resume: Optional[str] = None  # run dir to resume from (native checkpoints)
    checkpoint_every: int = 1     # native-resume checkpoint cadence (epochs)
    grad_accum: int = 1           # microbatches per optimizer step (extension)
