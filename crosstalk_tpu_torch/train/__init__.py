"""Training: schedules, the train and validation steps, and the epoch loop.

The JAX package's names, less ``batch_sharding`` and ``replicate_state``:
each rank keeps its own rows of a batch and its own copy of the state
(parallel/distributed.py), so there is nothing to shard or replicate. Plus
``finish_training_run``, the run-dir epilogue the train CLI shares.
"""

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
