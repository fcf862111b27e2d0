"""Training loop (port of crosstalk_tpu/train/loop.py).

The reference's ``train_model()`` (train_model.py:325-491): scheduler
registry, per-epoch train and validation passes, best-val ``.pth``, early
stopping, CSV log, LR plot. Each step's loss stays on the device; the loop
reads the epoch's losses back once, after its last step, so the host
enqueues a whole epoch without waiting on the card.

Divergences from the reference, shared with the JAX package:
  * train/val losses divide by the number of samples actually evaluated;
  * validation evaluates every sample through pad-and-mask instead of
    drop_last=True;
  * every ``checkpoint_every`` epochs (and on the last one) a full resume
    checkpoint is written (io/checkpoint.py), asynchronously: the state is
    cloned on the device and a background thread copies and writes it while
    the next epoch trains; everything is durable before ``train_model``
    returns;
  * ``resume`` also continues a run dir the JAX package trained: its state
    converts on load, and the JAX generation read is kept beside the port's
    checkpoints (``checkpoint.keep_jax_generation``).

Under a process group (crosstalk_tpu/train/loop.py:125-148, :154, :165-187,
:213-223) every rank runs this loop on its own rows of each batch; the
losses the steps return are global, so best model, early stop and schedule
stay in lockstep, while the log, the checkpoints, the plots and the prints
belong to rank 0.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from crosstalk_tpu_torch.config import OptimConfig, TrainConfig
from crosstalk_tpu_torch.data.pipeline import (
    DeviceDataset,
    TileStore,
    device_batches,
    iterate_batches,
    num_batches,
)
from crosstalk_tpu_torch.eval.engine import _progress
from crosstalk_tpu_torch.io import artifacts, checkpoint
from crosstalk_tpu_torch.parallel.distributed import (
    allgather_to_host,
    is_primary,
    process_row_slice,
    world_size,
)
from crosstalk_tpu_torch.train.schedules import Schedule
from crosstalk_tpu_torch.train.steps import TrainState, make_train_step, make_val_step


def train_model(
    state: TrainState,
    train_store: TileStore,
    val_store: TileStore,
    optim_cfg: OptimConfig,
    train_cfg: TrainConfig,
    run_dir: str,
    ts: str,
    compute_dtype: str = "bf16",
    seed: int = 43,
    resume: bool = False,
    naming_batch_size: Optional[int] = None,
    device_data: Optional[Tuple[DeviceDataset, DeviceDataset]] = None,
    process_group: Optional[dist.ProcessGroup] = None,
) -> Tuple[TrainState, List[float], List[float]]:
    """Run the full training schedule -> (state, train_losses, val_losses).

    ``naming_batch_size`` keeps artifact filenames on the CLI-requested batch
    size when the effective batch was clamped (the run-directory name
    already used the requested value).

    ``device_data``, the ``(train, val)`` splits resident on the model's
    device (``DeviceDataset``), replaces the per-step host-to-device copy
    with an on-device gather; the batch sequence is the host path's.
    Single-device only: with more than one rank each rank streams its rows
    through the host pipeline.

    ``process_group``: this process is one rank of it (see the module
    docstring); the model must be on this rank's device.
    """
    batch_size = train_cfg.batch_size
    naming_bs = naming_batch_size if naming_batch_size is not None else batch_size
    if batch_size <= 0:
        raise ValueError(f"batch size must be positive, got {batch_size}")
    steps_per_epoch = len(train_store) // batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"training split ({len(train_store)} samples) is smaller than the "
            f"batch size ({batch_size}); lower -b"
        )
    if len(val_store) == 0:
        raise ValueError("SplitCrosstalkDataset received no samples.")

    device = next(state.model.parameters()).device
    schedule = Schedule(optim_cfg, train_cfg.num_epochs, steps_per_epoch)
    train_step = make_train_step(state, compute_dtype=compute_dtype, seed=seed,
                                 grad_accum=train_cfg.grad_accum,
                                 process_group=process_group)
    val_step = make_val_step(state.model, compute_dtype=compute_dtype,
                             process_group=process_group)
    multirank = process_group is not None and world_size(process_group) > 1
    primary = is_primary(process_group)
    # each rank assembles only its rows of every batch
    assemble = process_row_slice(batch_size, process_group) if multirank else None

    if device_data is not None and multirank:
        raise ValueError("device_data is single-device only; with more than one "
                         "rank each rank streams its rows through the host pipeline")
    if device_data is not None:
        train_data, val_data = device_data

        def train_batches(epoch):
            return train_data.batches(batch_size, shuffle=True, drop_last=True,
                                      seed=seed, epoch=epoch)

        def val_batches():
            return val_data.batches(batch_size)
    else:
        def train_batches(epoch):
            return device_batches(
                iterate_batches(train_store, batch_size, shuffle=True,
                                drop_last=True, seed=seed, epoch=epoch,
                                assemble_rows=assemble),
                device)

        def val_batches():
            return device_batches(
                iterate_batches(val_store, batch_size, assemble_rows=assemble), device)

    train_losses: List[float] = []
    val_losses: List[float] = []
    lr_history: List[float] = []
    best_val_loss = float("inf")
    epochs_without_improvement = 0
    start_epoch = 0

    if resume:
        # loaded on the CPU: load_state_dict moves the weights and Adam
        # moments to the parameters' device and keeps Adam's step counts on
        # the host, where the non-capturable Adam reads them without a sync
        restored = checkpoint.load_checkpoint(
            run_dir, variant=getattr(state.model, "variant", None))
        if multirank:
            # rank 0 writes the checkpoints and every rank reads them from
            # its own run_dir: ranks that see different checkpoints (a
            # filesystem not shared by every host, a partial copy) would
            # restore different states, so they stop here, all of them
            local = np.array([[restored[1]["epoch"], restored[1]["global_step"]]
                              if restored is not None else [-1, -1]], np.int64)
            agreed = allgather_to_host(local, process_group)
            if not (agreed == agreed[0]).all():
                raise RuntimeError(
                    "multi-host resume desync: per-rank (epoch, step) = "
                    f"{agreed.tolist()} — the --resume run directory must "
                    "be on a filesystem shared by every host"
                )
        if restored is None:
            # a --resume with nothing restorable must not fall through to a
            # fresh run: TrainingLog(resume_from_epoch=0) would truncate the
            # original history and the epilogue would overwrite the run's
            # artifacts
            raise ValueError(
                f"--resume: no restorable checkpoint under "
                f"{run_dir}/checkpoints — wrong directory, cleaned "
                f"checkpoints, or a partial copy. Start a fresh run instead."
            )
        payload, meta = restored
        checkpoint.restore_state(state, payload)
        start_epoch = meta["epoch"]
        best_val_loss = meta["best_val_loss"]
        epochs_without_improvement = meta["epochs_without_improvement"]
        train_losses = list(meta["train_losses"])
        val_losses = list(meta["val_losses"])
        lr_history = list(meta["lr_history"])
        schedule.load_state_dict(meta["schedule"])
        if primary:
            print(f"Resumed from epoch {start_epoch} (best val {best_val_loss:.6f})")
            if "source_format" in meta:  # read from the JAX package's files
                kept = checkpoint.keep_jax_generation(run_dir, meta)
                print(f"Resumed a JAX-format checkpoint ({meta['source_file']}) at "
                      f"epoch {start_epoch}, step {state.step}: parameters, BatchNorm "
                      "statistics, Adam moments and step counts carried over; flips "
                      "and dropout draw from this package's random streams from here "
                      "on. Checkpoints are written in this package's format"
                      + (f"; the JAX generation is kept as {kept}" if kept else ""))

    log = artifacts.TrainingLog(
        run_dir, ts, naming_bs, optim_cfg.learning_rate,
        schedule.scheduler_type, schedule.params_dict,
        resume_from_epoch=start_epoch if resume else None,
    ) if primary else artifacts.NullTrainingLog()
    writer = checkpoint.AsyncCheckpointWriter() if primary else None
    try:
        for epoch in range(start_epoch, train_cfg.num_epochs):
            lr_history.append(schedule.lr_for_step(state.step))
            t0 = time.perf_counter()

            # ---- train pass: enqueue every step, read the losses once
            step_losses = []
            for batch in _progress(
                train_batches(epoch),
                f"Epoch {epoch + 1}/{train_cfg.num_epochs} [Train]" if primary else None,
                steps_per_epoch,
            ):
                lr = schedule.lr_for_step(state.step)
                step_losses.append(train_step(batch.inputs, batch.labels, lr))
            train_loss = torch.stack(step_losses).mean().item()
            train_losses.append(train_loss)
            tiles_per_sec = steps_per_epoch * batch_size / (time.perf_counter() - t0)

            # ---- validation pass (pad-and-mask, every sample)
            sq_sum = count = 0.0
            for batch in _progress(
                val_batches(),
                f"Epoch {epoch + 1}/{train_cfg.num_epochs} [Val]" if primary else None,
                num_batches(len(val_store), batch_size),
            ):
                s, c = val_step(batch.inputs, batch.labels, batch.mask)
                sq_sum, count = sq_sum + s, count + c
            val_loss = float(sq_sum) / max(float(count), 1.0)
            val_losses.append(val_loss)

            schedule.on_epoch_end(val_loss)

            # ---- best-model .pth for reference interop (train_model.py:456-461)
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                epochs_without_improvement = 0
                if primary:
                    writer.submit_pth(
                        f"{run_dir}/best_model_{schedule.scheduler_type}.pth",
                        state.model.state_dict(),
                    )
            else:
                epochs_without_improvement += 1

            current_lr = schedule.lr_for_step(state.step)
            if primary:
                print(
                    f"Epoch [{epoch + 1}/{train_cfg.num_epochs}] | "
                    f"Train Loss: {train_loss:.6f} | Val Loss: {val_loss:.6f} | "
                    f"LR: {current_lr:.2e} | {tiles_per_sec:,.0f} tiles/s"
                )
            log.log_epoch(epoch + 1, train_loss, val_loss, current_lr)

            # ---- resume checkpoint: every checkpoint_every epochs, on the
            #      last epoch, and on an early stop (which makes this epoch
            #      the last one)
            stopping = epochs_without_improvement >= schedule.early_stop_patience
            if primary and ((epoch + 1) % train_cfg.checkpoint_every == 0
                            or epoch + 1 == train_cfg.num_epochs or stopping):
                writer.submit_checkpoint(
                    run_dir,
                    checkpoint.state_payload(state, seed),
                    {
                        "epoch": epoch + 1,
                        "variant": getattr(state.model, "variant", None),
                        "global_step": state.step,
                        "best_val_loss": best_val_loss,
                        "epochs_without_improvement": epochs_without_improvement,
                        "train_losses": train_losses,
                        "val_losses": val_losses,
                        "lr_history": lr_history,
                        "schedule": schedule.state_dict(),
                    },
                )

            if stopping:
                if primary:
                    print(
                        f"Early stopping triggered after {epoch + 1} epochs "
                        f"(no improvement for {schedule.early_stop_patience} epochs)"
                    )
                break
    finally:
        # every submitted write durable (and any writer error raised) before
        # the caller reloads or evaluates artifacts
        if writer is not None:
            writer.close()
        log.close()
    if primary and artifacts.plot_lr_schedule(run_dir, lr_history, schedule.scheduler_type):
        print(f"Learning rate schedule plot saved to "
              f"{run_dir}/lr_schedule_{schedule.scheduler_type}.png")
    return state, train_losses, val_losses


def finish_training_run(
    model_for: Callable,
    state: TrainState,
    run_dir: str,
    naming_batch_size,
    learning_rate,
    store_for: Callable,
    eval_batch_size: int,
    train_losses,
    val_losses,
    compute_dtype: str = "bf16",
):
    """The post-training epilogue (train_model.py:644-673): the final
    ``.pth`` under the reference's name, the loss-curve plot, a reload of
    that file from disk, and the three per-split prediction CSVs and plots.

    ``model_for(state_dict)`` -> a model on the training device with those
    weights; ``store_for(split)`` -> the TileStore or DeviceDataset of
    'test'/'train'/'val'. -> (final_path, {split: mse}).
    """
    from crosstalk_tpu_torch.eval.engine import evaluate_and_save, model_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth

    ts2 = artifacts.timestamp()
    final_path = (
        f"{run_dir}/crosstalk_regression_model_trained_{ts2}_"
        f"{naming_batch_size}_{learning_rate}.pth"
    )
    save_pth(final_path, state.model.state_dict())
    print(f"Trained model weights saved to {final_path}")

    if artifacts.plot_loss_curves(run_dir, train_losses, val_losses, ts2,
                                  naming_batch_size, learning_rate):
        print("Training and validation loss plot saved")

    print("\n--- Evaluating Model ---")
    loaded = model_for(load_pth(final_path))
    forward = model_forward(loaded, compute_dtype)
    device = next(loaded.parameters()).device
    suffix = f"{ts2}_{naming_batch_size}_{learning_rate}"
    split_mse = {}
    for split in ("test", "train", "val"):
        print(f"\n--- Evaluating Model on {split.capitalize()} Set ---")
        split_mse[split] = evaluate_and_save(
            forward, store_for(split), device,
            dataset_name=split, output_dir=run_dir, ts=ts2,
            batch_size=eval_batch_size, train_suffix=suffix,
        )
    return final_path, split_mse
