"""Train and validation steps (port of crosstalk_tpu/train/steps.py).

The reference's inner loop is zero_grad -> forward -> MSE -> backward -> step
on one device (train_model.py:419-424). Here a step is: on-device normalize
and paired flips, the forward in train mode (bf16 autocast when the model's
compute dtype is ``'bf16'``; parameters stay float32), MSE in the labels'
dtype (float32), backward, and one Adam step with the L2 term coupled into
the gradient.

Nothing in a step reads a value back to the host: the loss comes back as a
device tensor, the learning rate goes in as a Python float on the param
groups, and the step counter is a host integer. The loop syncs once per
epoch (train/loop.py).

Random draws are stateless functions of (seed, global step): the flips of
``data/transforms.py`` and the dropout and drop-path masks of
``models/layers.SeededDropout`` and ``SeededDropPath``, whose generator is
re-seeded per (seed, step, microbatch) and drawn from in forward order. A
resumed run therefore draws what the uninterrupted run drew.

While a profiler runs, the spans ``crosstalk.train.forward``,
``crosstalk.train.backward`` and ``crosstalk.train.optimizer``
(``utils.profiling.span``) cover the host's enqueue of each phase.

Data parallelism (crosstalk_tpu/train/steps.py:102-118, :157-159, :172-174,
:206-208): with a ``process_group`` each rank steps on its own rows of the
global batch. ``DistributedDataParallel`` takes the mean of the gradients
over the ranks (the JAX package's ``pmean``), the loss is all-reduced to its
mean, the BatchNorms are cross-replica when the model was built with the
group (``models.registry.build_model(process_group=...)``), and the
validation sums are all-reduced. The flips draw from each example's global
index (rank x local batch + its row), so they equal the single-device
flips; dropout masks are whole-activation draws that depend on the shard's
shape, so each rank folds its rank into the dropout seed (the JAX package
folds in ``axis_index``). With those, N ranks take the step one device
takes on the concatenated batch, up to the order of floating-point sums
and the dropout masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from crosstalk_tpu_torch.config import OptimConfig
from crosstalk_tpu_torch.data.transforms import (
    DROPOUT_STREAM,
    counter_key,
    normalize_batch_nhwc,
    prepare_train_batch,
)
from crosstalk_tpu_torch.models.layers import SeededDropout, SeededDropPath
from crosstalk_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """What the JAX package's TrainState pytree holds: the model (parameters
    and BN running statistics), the optimizer (Adam moments) and the count of
    optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, cfg: OptimConfig) -> torch.optim.Adam:
    """torch.optim.Adam with coupled L2 (train_model.py:637): Adam+L2, not
    AdamW. The learning rate is set on the param groups before each step."""
    return torch.optim.Adam(
        params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
        eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
    )


def init_train_state(model: nn.Module, cfg: OptimConfig) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), cfg))


def _autocast(device: torch.device, compute_dtype: str):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == "bf16")


def make_train_step(
    state: TrainState,
    compute_dtype: str = "bf16",
    seed: int = 43,
    augment: bool = True,
    grad_accum: int = 1,
    process_group: Optional[dist.ProcessGroup] = None,
) -> Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]:
    """-> fn(inputs, labels, lr) -> loss (a 0-d device tensor).

    ``inputs`` are raw (B, H, W, 2) float32 tiles and ``labels`` (B, 1), on
    the model's device. Each call takes one optimizer step and advances
    ``state.step``; its flips and dropout masks are drawn for that step.

    ``grad_accum=N`` splits the batch into N sequential microbatches,
    ``(loss / N).backward()`` each, then one ``optimizer.step()``: the
    accumulation loop every torch user writes. Each microbatch is normalized
    by its own BatchNorm batch statistics and the running statistics update
    per microbatch, as in the JAX package's ``lax.scan`` step. Flips stay
    those of the whole batch (each example draws from its global index).

    With ``process_group``, ``inputs`` are this rank's rows of the global
    batch (``parallel.process_row_slice``), the model is wrapped in
    ``DistributedDataParallel`` (once: call this once per model), and the
    returned loss is the mean over the ranks. At one rank the step is
    bitwise the plain one (the gradient and loss means divide by 1). Build
    the model with the same group for cross-replica BatchNorm statistics.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    model, opt = state.model, state.optimizer
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    for m in model.modules():
        if isinstance(m, (SeededDropout, SeededDropPath)):
            m.generator = gen
    world, rank, module = 1, 0, model
    if process_group is not None:
        from torch.nn.parallel import DistributedDataParallel

        world, rank = dist.get_world_size(process_group), dist.get_rank(process_group)
        # the running statistics are equal on every rank already (the
        # cross-replica BatchNorm), so they are not broadcast per forward
        # (newer torch warns that this flag is renamed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            module = DistributedDataParallel(
                model, device_ids=[device] if device.type == "cuda" else None,
                process_group=process_group, broadcast_buffers=False)

    def step_fn(inputs: torch.Tensor, labels: torch.Tensor, lr: float) -> torch.Tensor:
        b = inputs.shape[0]
        if b % grad_accum:
            raise ValueError(f"per-step batch {b} must divide by grad_accum {grad_accum}")
        micro = b // grad_accum
        for group in opt.param_groups:
            group["lr"] = lr
        model.train()
        opt.zero_grad(set_to_none=True)
        loss_sum = None
        for i in range(grad_accum):
            rows = slice(i * micro, (i + 1) * micro)
            batch = prepare_train_batch(inputs[rows], seed, state.step, augment,
                                        index_offset=rank * b + i * micro)
            key = (seed, state.step, DROPOUT_STREAM, i) + ((rank,) if world > 1 else ())
            gen.manual_seed(counter_key(*key))
            # DDP all-reduces the gradients after the last microbatch only
            sync = i == grad_accum - 1 or module is model
            with (contextlib.nullcontext() if sync else module.no_sync()):
                with span("crosstalk.train.forward", host_only=False), \
                        _autocast(device, compute_dtype):
                    preds = module(batch.permute(0, 3, 1, 2))
                loss = F.mse_loss(preds.to(labels.dtype), labels[rows])
                with span("crosstalk.train.backward", host_only=False):
                    (loss / grad_accum).backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        with span("crosstalk.train.optimizer", host_only=False):
            opt.step()
        state.step += 1
        loss = loss_sum / grad_accum
        if process_group is not None:
            dist.all_reduce(loss, group=process_group)
            loss = loss / world
        return loss

    return step_fn


def make_val_step(model: nn.Module, compute_dtype: str = "bf16",
                  process_group: Optional[dist.ProcessGroup] = None):
    """-> fn(inputs, labels, mask) -> (sq_err_sum, count), both 0-d device
    tensors; padding rows (mask 0) add nothing. Runs the model in eval mode.
    With ``process_group`` the inputs are this rank's rows and both sums
    are over every rank's rows."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step_fn(inputs, labels, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        batch = normalize_batch_nhwc(inputs)
        with _autocast(device, compute_dtype):
            preds = model(batch.permute(0, 3, 1, 2))
        sq_err = torch.square(preds.to(labels.dtype) - labels)[:, 0] * mask
        sums = torch.stack([sq_err.sum(), mask.sum()])
        if process_group is not None:
            dist.all_reduce(sums, group=process_group)
        return sums[0], sums[1]

    return step_fn
