"""The port's LR schedules against the JAX package's: the same floats, step
by step, for all three schedulers (plateau reductions included), the same
``params_dict`` and the same ``state_dict`` round trip."""

import dataclasses

import pytest

import crosstalk_tpu.config as jcfg
from crosstalk_tpu.train import schedules as jsched
from crosstalk_tpu_torch.config import (
    EARLY_STOP_PATIENCE,
    SCHEDULER_TYPE_NAMES,
    OptimConfig,
    TrainConfig,
)
from crosstalk_tpu_torch.train import schedules as sched

EPOCHS, STEPS = 3, 5
# val losses that improve, stall past the (shortened) patience, then improve
VAL = [0.5, 0.5, 0.5, 0.49, 0.49, 0.49, 0.1]


def test_config_defaults_equal_the_jax_package():
    for port_cls, jax_cls in ((OptimConfig, jcfg.OptimConfig),
                              (TrainConfig, jcfg.TrainConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert EARLY_STOP_PATIENCE == jcfg.EARLY_STOP_PATIENCE
    assert SCHEDULER_TYPE_NAMES == jcfg.SCHEDULER_TYPE_NAMES


@pytest.mark.parametrize("name", ["aggressive_plateau", "onecycle", "cosine_warmup"])
def test_schedule_floats_equal_jax(name):
    kw = dict(scheduler=name, learning_rate=3e-4, plateau_patience=0,
              warmup_epochs=2)
    ours = sched.Schedule(OptimConfig(**kw), EPOCHS, STEPS)
    theirs = jsched.Schedule(jcfg.OptimConfig(**kw), EPOCHS, STEPS)
    assert (ours.scheduler_type, ours.early_stop_patience) == (
        theirs.scheduler_type, theirs.early_stop_patience)
    assert ours.params_dict == theirs.params_dict
    lrs = []
    step = 0
    for epoch in range(EPOCHS):
        for _ in range(STEPS):
            lrs.append(ours.lr_for_step(step))
            assert lrs[-1] == theirs.lr_for_step(step)
            step += 1
        ours.on_epoch_end(VAL[epoch])
        theirs.on_epoch_end(VAL[epoch])
        assert ours.state_dict() == theirs.state_dict()
    assert len(set(lrs)) > 1  # the schedule moved

    fresh = sched.Schedule(OptimConfig(**kw), EPOCHS, STEPS)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.state_dict() == ours.state_dict()
    assert fresh.lr_for_step(step) == ours.lr_for_step(step)


def test_plateau_reductions_and_min_lr_guard_equal_jax():
    ours = sched.ReduceLROnPlateau(1e-7, patience=1, min_lr=1e-8)
    theirs = jsched.ReduceLROnPlateau(1e-7, patience=1, min_lr=1e-8)
    seen = []
    for v in VAL * 3:
        seen.append(ours.step(v))
        assert seen[-1] == theirs.step(v)
        assert ours.state_dict() == theirs.state_dict()
    assert min(seen) < 1e-7  # reduced, then held by the 1e-8 guard


@pytest.mark.parametrize("total", [1, 7, 50, 333])
def test_onecycle_and_warmup_cosine_equal_jax(total):
    for step in range(total + 2):
        assert sched.onecycle_lr(step, total) == jsched.onecycle_lr(step, total)
    for epoch in range(total + 2):
        assert (sched.warmup_cosine_lr(epoch, total)
                == jsched.warmup_cosine_lr(epoch, total))


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        sched.Schedule(OptimConfig(scheduler="cyclic"), 1, 1)
