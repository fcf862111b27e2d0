"""Training: schedules, the train and validation steps, and the epoch loop."""

from crosstalk_tpu_torch.train.loop import finish_training_run, train_model
from crosstalk_tpu_torch.train.schedules import (
    ReduceLROnPlateau,
    Schedule,
    onecycle_lr,
    warmup_cosine_lr,
)
from crosstalk_tpu_torch.train.steps import (
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
    make_val_step,
)

__all__ = [
    "train_model",
    "finish_training_run",
    "TrainState",
    "make_optimizer",
    "init_train_state",
    "make_train_step",
    "make_val_step",
    "Schedule",
    "ReduceLROnPlateau",
    "onecycle_lr",
    "warmup_cosine_lr",
]
