"""Learning-rate schedules (the port's copy of crosstalk_tpu/train/schedules.py)
— the reference's three-entry scheduler registry (train_model.py:330-366)
with torch-exact formulas, giving the same floats as the JAX package.

All schedules here are *host-side* scalar functions: the train step sets
the learning rate on the optimizer's param groups before each step, so
stateful schedules (plateau) stay trivially correct.

1. ``aggressive_plateau`` -> :class:`ReduceLROnPlateau` — torch
   ReduceLROnPlateau(factor=0.3, patience=3, threshold=5e-5, min_lr=1e-8)
   semantics (relative threshold, min mode), stepped per epoch on val loss
   (train_model.py:449-450). Early-stop patience 8.
2. ``onecycle`` -> :func:`onecycle_lr` — torch OneCycleLR(max_lr=1e-3,
   pct_start=0.3, anneal_strategy='cos', div_factor=25, final_div_factor=1e4,
   three-phase off), stepped per *batch* (train_model.py:429-430); the
   max_lr deliberately overrides the CLI lr exactly as the reference does
   (train_model.py:345). Early-stop patience 20.
3. ``cosine_warmup`` -> :func:`warmup_cosine_lr` — the reference's version is
   BROKEN (its config type 'custom_warmup' is never constructed, so epoch 1
   ends in a NameError — train_model.py:356-365, 376-387, 451-452). We
   implement what its parameters describe: 5 epochs of linear warmup to
   max_lr=1e-4, then cosine decay to final_lr=1e-7 over the remaining
   epochs; stepped per epoch. Early-stop patience 15. DIVERGENCE: this one works.
"""

from __future__ import annotations

import math

from crosstalk_tpu_torch.config import EARLY_STOP_PATIENCE, SCHEDULER_TYPE_NAMES, OptimConfig


def _cos_anneal(start: float, end: float, pct: float) -> float:
    """torch.optim.lr_scheduler.OneCycleLR._annealing_cos."""
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def onecycle_lr(
    step: int,
    total_steps: int,
    max_lr: float = 1e-3,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> float:
    """LR for global batch index ``step`` (0-based), torch OneCycleLR cos."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - up_steps - 1.0)
    if step <= up_steps:
        return _cos_anneal(initial_lr, max_lr, step / up_steps if up_steps > 0 else 1.0)
    pct = (step - up_steps) / down_steps if down_steps > 0 else 1.0
    return _cos_anneal(max_lr, min_lr, pct)


def warmup_cosine_lr(
    epoch: int,
    total_epochs: int,
    warmup_epochs: int = 5,
    max_lr: float = 1e-4,
    final_lr: float = 1e-7,
) -> float:
    """LR for epoch index ``epoch`` (0-based): linear warmup then cosine."""
    if epoch < warmup_epochs:
        return max_lr * (epoch + 1) / warmup_epochs
    span = max(total_epochs - warmup_epochs - 1, 1)
    pct = min((epoch - warmup_epochs) / span, 1.0)
    return _cos_anneal(max_lr, final_lr, pct)


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau, min mode, relative threshold, cooldown 0.

    is_better(current) := current < best * (1 - threshold).
    After ``patience`` consecutive not-better epochs, lr <- max(lr * factor,
    min_lr) and the bad-epoch counter resets.
    """

    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.3,
        patience: int = 3,
        threshold: float = 5e-5,
        min_lr: float = 1e-8,
    ):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        """Record an epoch's validation metric; returns the (possibly
        reduced) learning rate to use from the next epoch on."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            # torch applies the reduction only when it exceeds eps=1e-8
            # (torch/optim/lr_scheduler.py ReduceLROnPlateau._reduce_lr)
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > 1e-8:
                self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


class Schedule:
    """One interface over the three schedulers.

    ``lr_for_step(global_step)`` is consulted before every batch;
    ``on_epoch_end(val_loss)`` after every epoch. ``scheduler_type`` is the
    registry type string used in artifact filenames (plateau / onecycle /
    custom_warmup — train_model.py:331,343,357).
    """

    def __init__(self, cfg: OptimConfig, num_epochs: int, steps_per_epoch: int):
        self.name = cfg.scheduler
        if self.name not in SCHEDULER_TYPE_NAMES:
            raise ValueError(
                f"unknown scheduler {self.name!r} "
                f"(choose from {sorted(SCHEDULER_TYPE_NAMES)})"
            )
        self.scheduler_type = SCHEDULER_TYPE_NAMES[self.name]
        self.early_stop_patience = EARLY_STOP_PATIENCE[self.name]
        self.cfg = cfg
        self.num_epochs = num_epochs
        self.steps_per_epoch = steps_per_epoch
        self._epoch = 0
        self._plateau = ReduceLROnPlateau(
            cfg.learning_rate,
            factor=cfg.plateau_factor,
            patience=cfg.plateau_patience,
            threshold=cfg.plateau_threshold,
            min_lr=cfg.plateau_min_lr,
        )

    @property
    def params_dict(self) -> dict:
        """Scheduler params recorded in the training-log CSV metadata row
        (train_model.py:404), mirroring the registry entries."""
        c = self.cfg
        if self.name == "aggressive_plateau":
            return {
                "factor": c.plateau_factor,
                "patience": c.plateau_patience,
                "threshold": c.plateau_threshold,
                "min_lr": c.plateau_min_lr,
            }
        if self.name == "onecycle":
            return {
                "max_lr": c.onecycle_max_lr,
                "pct_start": c.onecycle_pct_start,
                "anneal_strategy": "cos",
                "div_factor": c.onecycle_div_factor,
                "final_div_factor": c.onecycle_final_div_factor,
                "epochs": self.num_epochs,
                "steps_per_epoch": self.steps_per_epoch,
            }
        return {
            "warmup_epochs": c.warmup_epochs,
            "max_lr": c.warmup_max_lr,
            "final_lr": c.warmup_final_lr,
            "total_epochs": self.num_epochs,
        }

    def lr_for_step(self, global_step: int) -> float:
        if self.name == "onecycle":
            return onecycle_lr(
                global_step,
                total_steps=self.num_epochs * self.steps_per_epoch,
                max_lr=self.cfg.onecycle_max_lr,
                pct_start=self.cfg.onecycle_pct_start,
                div_factor=self.cfg.onecycle_div_factor,
                final_div_factor=self.cfg.onecycle_final_div_factor,
            )
        if self.name == "cosine_warmup":
            return warmup_cosine_lr(
                self._epoch,
                total_epochs=self.num_epochs,
                warmup_epochs=self.cfg.warmup_epochs,
                max_lr=self.cfg.warmup_max_lr,
                final_lr=self.cfg.warmup_final_lr,
            )
        return self._plateau.lr

    def on_epoch_end(self, val_loss: float) -> None:
        self._epoch += 1
        if self.name == "aggressive_plateau":
            self._plateau.step(val_loss)

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "plateau": self._plateau.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state["epoch"]
        self._plateau.load_state_dict(state["plateau"])
