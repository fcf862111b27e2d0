"""Training CLI (port of crosstalk_tpu/cli/train.py): the reference's
``train_model.py`` surface (flags and defaults: train_model.py:495-513;
behavior: 515-677).

Discovers paired tiles, splits 70/15/15 with the reference's seeded
permutation, trains with the selected scheduler, and writes the
``training_run_{ts}_B{bs}_LR{lr}/`` artifact set: params.txt,
model_architecture.txt, the training-log CSV, the best-model and final
``.pth`` (reference key schema), loss/LR plots, and the per-split
prediction CSVs and scatter plots that ``analyse_training_results.py``
reads.

    python -m crosstalk_tpu_torch.cli.train -m MIXED -s SOURCE [-b 256 -n 50 ...]

Runs on the CUDA card (``--device cpu`` to run on the CPU explicitly).

Data parallel: ``--num_devices N`` (default: every visible card; 1 with
``--device cpu``) starts N ranks on this host, one process per device, on
a free localhost port (``parallel.distributed.launch_local``).
``--multihost`` with ``--coordinator_address``, ``--num_processes`` and
``--process_id`` (or the ``CROSSTALK_*`` variables) makes this process one
rank of a cluster instead; there each process drives one device, so
``--num_devices``, when given, must equal ``--num_processes`` (the JAX
package runs one process per host over all its chips). Ranks use NCCL on
cards and Gloo on the CPU. Rank 0 owns stdout and the artifacts.
``--resume`` continues a run dir of either package: one the JAX package
trained on a TPU resumes on the card with its Adam moments, step counts and
schedule (io/checkpoint.py). ``--profile DIR`` writes a ``torch.profiler``
trace of training;
``--debug_nans`` fails on the first NaN or Inf (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import re
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Script for training with various parameters."
    )
    parser.add_argument("-m", "--mixed_channel_data_dir", type=str,
                        default="./Training_Data/Mixed",
                        help="Directory for mixed channel data")
    parser.add_argument("-s", "--pure_source_data_dir", type=str,
                        default="./Training_Data/Source",
                        help="Directory for pure source data")
    parser.add_argument("-b", "--batch_size", type=int, default=256,
                        help="Batch size for training")
    parser.add_argument("-l", "--learning_rate", type=float, default=1e-4,
                        help="Learning rate for training")
    parser.add_argument("-n", "--num_epochs", type=int, default=50,
                        help="Number of epochs for training")
    parser.add_argument("-t", "--train_ratio", type=float, default=0.7,
                        help="Training data ratio")
    parser.add_argument("-v", "--val_ratio", type=float, default=0.15,
                        help="Validation data ratio")
    parser.add_argument("-j", "--cpu_jobs", type=int, default=1,
                        help="Number of CPUs to use")
    parser.add_argument("-o", "--model_options", type=str, default="single",
                        help="Use single- or double-branch model",
                        choices=["single", "double"])
    parser.add_argument("-r", "--learning_scheduler", type=str,
                        default="aggressive_plateau",
                        help="Use aggressive_plateau, onecycle or cosine_warmup "
                             "learning scheduler",
                        choices=["aggressive_plateau", "onecycle", "cosine_warmup"])
    # Extensions beyond the reference surface:
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override (reference config: 128 "
                             "for single, 64 per branch for double)")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override (reference: 6). "
                             "Input tiles must be at least 2^depth pixels. "
                             "The two-branch trunk is fixed at 4 blocks")
    parser.add_argument("--compute_dtype", type=str, default="bf16",
                        choices=["bf16", "f32"],
                        help="bf16 = bf16 autocast with float32 parameters; "
                             "f32 = float32 with TF32 off")
    parser.add_argument("--dropout", type=float, default=None,
                        help="Dropout rate override (reference hardcodes "
                             "0.1 single / 0.5 double — regression_model.py:"
                             "39,44, two_branch_regression.py:45,50)")
    parser.add_argument("--output_base", type=str, default=".",
                        help="Where to create the training_run_* directory")
    parser.add_argument("--resume", type=str, default=None,
                        help="Existing training_run_* directory to resume from "
                             "(one this package or the JAX package trained)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Data-parallel device count: one rank per "
                             "device (default: every visible card; 1 with "
                             "--device cpu)")
    parser.add_argument("--seed", type=int, default=43,
                        help="Split/init/augmentation seed (reference: 43)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of training to DIR")
    parser.add_argument("--checkpoint_every", type=int, default=1,
                        help="Resume-checkpoint cadence in epochs "
                             "(the final epoch always checkpoints)")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Microbatches per optimizer step (default 1 = "
                             "reference semantics). N splits each batch into "
                             "N sequential forward/backward passes: peak "
                             "activation memory drops while the optimizer "
                             "sees the full-batch mean gradient. Per-"
                             "microbatch BatchNorm stats; the batch size "
                             "must divide by N (and by N x ranks)")
    parser.add_argument("--data_placement", type=str, default="auto",
                        choices=["auto", "host", "device"],
                        help="'device' keeps the splits resident on the card "
                             "(one upload, no per-step host-to-device copy; "
                             "one rank only); 'host' streams batches from "
                             "host memory; 'auto' picks device on a single "
                             "CUDA card when all three splits take at most a "
                             "quarter of its free memory, else host")
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="Directory for the packed decoded-tile cache "
                             "(memory-mapped; repeat runs skip TIFF decode)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Fail fast on NaN/Inf: autograd anomaly mode and "
                             "a finite check of every module's output (note: "
                             "a genuinely constant tile yields NaN "
                             "correlation metrics by reference semantics and "
                             "will trip this during post-training eval)")
    # Multi-host: one process per device. Nothing on a GPU host detects the
    # cluster, so all three come from the flags or the CROSSTALK_COORDINATOR /
    # CROSSTALK_NUM_PROCESSES / CROSSTALK_PROCESS_ID variables.
    parser.add_argument("--multihost", action="store_true",
                        help="Join a multi-process cluster as one rank "
                             "(torch.distributed)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port where rank 0 listens")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Total process (rank) count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="This process's rank")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Run on the CUDA card (default) or the CPU")
    return parser


def _parallel_layout(args):
    """-> (world size, whether this process is one rank of a --multihost
    cluster), or an error message. Checked before anything is written."""
    from crosstalk_tpu_torch.device import resolve_device
    from crosstalk_tpu_torch.parallel.distributed import cluster_spec
    from crosstalk_tpu_torch.parallel.mesh import visible_devices

    device = resolve_device(args.device)  # raises when CUDA is missing
    multihost = bool(args.multihost or args.coordinator_address
                     or os.environ.get("CROSSTALK_COORDINATOR"))
    if multihost:
        try:
            _, world, _ = cluster_spec(args.coordinator_address, args.num_processes,
                                       args.process_id)
        except ValueError as e:
            return f"Error: --multihost: {e}."
        if args.num_devices is not None and args.num_devices != world:
            return (f"Error: --num_devices {args.num_devices} must equal "
                    f"--num_processes {world} under --multihost (each process "
                    "drives one device).")
    else:
        visible = visible_devices(device.type)
        world = args.num_devices
        if world is None:
            world = visible if device.type == "cuda" else 1
        if world <= 0 or world > visible:
            return (f"Error: --num_devices {world} requested but only "
                    f"{visible} device(s) are visible.")
    if world > 1:
        if args.data_placement == "device":
            return ("Error: --data_placement device is single-device only "
                    "(each rank streams its own rows).")
        per_rank = max((args.batch_size // world) * world, world) // world
        if per_rank % args.grad_accum:
            return (f"Error: per-device batch {per_rank} must divide by "
                    f"--grad_accum {args.grad_accum}")
    return world, multihost


class _NonPrimaryStdout(io.TextIOBase):
    """stdout of ranks other than 0: rank 0 owns it. Error and Warning
    lines still surface on stderr, tagged with the rank, so a failing rank
    does not leave the cluster hanging without a word. TextIOBase supplies
    the rest of the file API for libraries that probe the stream."""

    def __init__(self, rank):
        super().__init__()
        self._rank = rank

    def writable(self):
        return True

    def write(self, s):
        if "Error" in s or "Warning" in s:
            sys.stderr.write(f"[rank {self._rank}] {s}")
        return len(s)


def _rank_main(args) -> int:
    """One rank: join the cluster (from the flags or the CROSSTALK_*
    variables ``launch_local`` sets), drive this rank's device, train."""
    import torch
    import torch.distributed as dist

    from crosstalk_tpu_torch.parallel.distributed import initialize, rank, rank_device

    group = initialize(args.coordinator_address, args.num_processes, args.process_id,
                       device_type=args.device)
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the host's cores, shared by its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    stdout = sys.stdout
    if rank() != 0:
        sys.stdout = _NonPrimaryStdout(rank())
    try:
        return _train(args, device, group)
    finally:
        sys.stdout = stdout
        dist.destroy_process_group()


def placement_budget(device) -> int:
    """Bytes the three splits may take on ``device`` under
    ``--data_placement auto``: a quarter of the card's free memory, leaving
    the rest to parameters, optimizer state and activations; 0 on the CPU,
    where the tiles already live in host memory."""
    import torch

    if device.type != "cuda":
        return 0
    free, _ = torch.cuda.mem_get_info(device)
    return free // 4


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # guard the flags that would otherwise surface as ZeroDivisionError /
    # scheduler tracebacks deep in the run
    for name, value in (("--batch_size", args.batch_size),
                        ("--num_epochs", args.num_epochs),
                        ("--learning_rate", args.learning_rate),
                        ("--checkpoint_every", args.checkpoint_every),
                        ("--grad_accum", args.grad_accum)):
        if value <= 0:
            print(f"Error: {name} must be positive, got {value}")
            return 1
    layout = _parallel_layout(args)
    if isinstance(layout, str):
        print(layout)
        return 1
    world, multihost = layout
    if multihost:
        return _rank_main(args)
    if world > 1:
        from crosstalk_tpu_torch.parallel.distributed import launch_local

        return launch_local(_rank_main, world, args)
    from crosstalk_tpu_torch.device import resolve_device

    return _train(args, resolve_device(args.device), None)


def _train(args, device, group) -> int:
    """The run on ``device``: one process, or one rank of ``group``."""
    import torch
    import torch.distributed as dist

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
    from crosstalk_tpu_torch.data.index import PairIndex, split_samples
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore
    from crosstalk_tpu_torch.device import device_label, set_parity_numerics
    from crosstalk_tpu_torch.io import artifacts
    from crosstalk_tpu_torch.models.registry import (
        build_model,
        init_model,
        torch_style_repr,
    )
    from crosstalk_tpu_torch.parallel.distributed import allgather_to_host
    from crosstalk_tpu_torch.train.loop import finish_training_run, train_model
    from crosstalk_tpu_torch.train.steps import init_train_state
    from crosstalk_tpu_torch.utils.profiling import enable_debug_checks, maybe_trace

    if args.debug_nans:
        enable_debug_checks()
    set_parity_numerics()
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    primary = rank == 0
    multirank = world > 1
    print(f"Using device: {device_label(device)} x{world}"
          + (f", {world} processes" if multirank else ""))

    if args.resume:
        # A resumed run continues the SAME run: the hyperparameters that
        # define it (naming, split, schedule, model) come from the original
        # params.txt, not this invocation's flags/defaults. -n stays from the
        # invocation: it is the (extendable) total-epoch target.
        original = artifacts.read_params_txt(args.resume)
        # one rank: fail cleanly up front when there is nothing to restore.
        # Several ranks skip this (a rank returning early would leave the
        # others in the digest all-gather below, which owns that failure)
        if not multirank and not glob.glob(os.path.join(args.resume, "checkpoints", "*")):
            print(f"Error: no checkpoints under {args.resume}/checkpoints — "
                  "nothing to resume (wrong directory, cleaned checkpoints, "
                  "or a partial copy). Start a fresh run instead.")
            return 1
        # run dirs that predate an identity flag recorded no key for it;
        # their effective value was the flag's default
        if original:
            original.setdefault("grad_accum", "1")
            original.setdefault("dropout", "None")
            original.setdefault("initial_filters", "None")
            original.setdefault("num_conv_blocks", "None")
        adopted = artifacts.adopt_run_identity(original, args, (
            ("batch_size", int), ("learning_rate", float),
            ("learning_scheduler", str), ("model_options", str),
            ("compute_dtype", str), ("seed", int),
            ("train_ratio", float), ("val_ratio", float),
            ("initial_filters", artifacts.opt_int),
            ("num_conv_blocks", artifacts.opt_int),
            ("dropout", lambda v: None if v in (None, "None", "") else float(v)),
            ("grad_accum", int),
        ))
        if adopted:
            print("Resume: adopting the original run's hyperparameters: "
                  + ", ".join(adopted))
        if multirank:
            # every rank must see the same --resume directory (params.txt
            # and checkpoint files): on a filesystem not shared by every
            # host the ranks would adopt different hyperparameters and
            # restore different states. train/loop.py's (epoch, step)
            # all-gather catches checkpoint CONTENT the names cannot reveal.
            import hashlib

            import numpy as np

            ckpt_files = sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(args.resume, "checkpoints", "*")))
            src = repr(sorted(original.items())) + repr(ckpt_files)
            digest = int.from_bytes(hashlib.sha256(src.encode()).digest()[:7], "little")
            agreed = allgather_to_host(np.array([digest], np.int64), group)
            if not (agreed == agreed[0]).all():
                print("Error: multi-host resume desync — the ranks see "
                      "different --resume directory contents "
                      "(params.txt/checkpoints). The run directory must be "
                      "on a filesystem shared by every host.")
                return 1

    if not (abs(args.train_ratio + args.val_ratio) < 1.0):
        print("Warning: Sum of TRAIN_RATIO, VAL_RATIO, TEST_RATIO does not equal 1.0.")

    if args.num_conv_blocks is not None and args.model_options == "double":
        print("Error: --num_conv_blocks applies to the single-branch model "
              "only (the two-branch trunk is fixed at 4 blocks per branch).")
        return 1
    model_kw = {}
    if args.initial_filters is not None:
        if args.model_options == "single":
            model_kw["initial_filters"] = args.initial_filters
        else:
            model_kw["initial_filters_per_branch"] = args.initial_filters
    if args.num_conv_blocks is not None:
        model_kw["num_conv_blocks"] = args.num_conv_blocks
    if args.dropout is not None:
        if not (0.0 <= args.dropout < 1.0):
            print("Error: --dropout must be in [0, 1).")
            return 1
        if args.model_options == "single":
            model_kw["dropout_single"] = args.dropout
        else:
            model_kw["dropout_double"] = args.dropout
    model_cfg = ModelConfig(variant=args.model_options,
                            compute_dtype=args.compute_dtype, **model_kw)
    print(f"Using {args.cpu_jobs} cpu workers.")

    if args.resume:
        run_dir = args.resume
        m = re.search(r"training_run_(.*)_B\d+_LR", run_dir)
        ts = m.group(1) if m else artifacts.timestamp()
        print(f"Resuming run in: {run_dir}")
    elif primary:
        ts = artifacts.timestamp()
        run_dir = artifacts.make_training_run_dir(
            args.output_base, ts, args.batch_size, args.learning_rate
        )
    else:  # the other ranks never create or write the run dir
        ts = artifacts.timestamp()
        run_dir = os.path.join(args.output_base, f"training_run_rank{rank}")
    print(f"Saving all outputs to: {run_dir}")

    # on resume, params.txt is the ORIGINAL run's record: keep it and log
    # the resume invocation separately
    if primary and args.resume:
        artifacts.write_params_txt(run_dir, vars(args), filename="params_resume.txt")
        print(f"Resume parameters saved to {run_dir}/params_resume.txt")
    elif primary:
        artifacts.write_params_txt(run_dir, vars(args))
        print(f"Parameters saved to {run_dir}/params.txt")

    # Quickstart bootstrap: the reference bundles Training_Data/ (100 paired
    # tiles) so its zero-flag `python train_model.py` just works. When both
    # data flags are at their defaults and the directory is absent, generate
    # an equivalent 100-pair sample set there once (data/synthetic.py).
    if (args.mixed_channel_data_dir == "./Training_Data/Mixed"
            and args.pure_source_data_dir == "./Training_Data/Source"
            and not os.path.isdir(args.mixed_channel_data_dir) and not multirank):
        from crosstalk_tpu_torch.data.synthetic import generate_dataset

        print("\nDefault data directory ./Training_Data is missing — "
              "generating the 100-pair sample dataset (the reference's "
              "bundled Training_Data equivalent)...")
        generate_dataset("./Training_Data", num_pairs=100, size=256, seed=0,
                         progress_every=0)
        print("Sample dataset written to ./Training_Data/{Mixed,Source}.")

    print("\nCreating dataset instances for initial file listing...")
    try:
        index = PairIndex(args.mixed_channel_data_dir, args.pure_source_data_dir)
        print(f"Found {len(index)} matching samples.")
        print(f"Total samples found in directories: {len(index)}")
    except (ValueError, FileNotFoundError) as e:
        print(f"Error initializing temporary dataset: {e}")
        return 1

    print("\nSplitting data using filename lists for correct augmentation application...")
    train_samples, val_samples, test_samples = split_samples(
        index.samples, args.train_ratio, args.val_ratio, seed=args.seed
    )
    print(
        f"Split sizes: Train = {len(train_samples)}, "
        f"Validation = {len(val_samples)}, Test = {len(test_samples)}"
    )

    # the batch stays positive and a multiple of the ranks (-b 4 over 8
    # ranks becomes 8, not 0); each rank steps on batch / ranks rows
    batch_size = args.batch_size
    if batch_size > len(train_samples):
        batch_size = max((len(train_samples) // world) * world, world)
        print(
            f"Warning: batch size {args.batch_size} exceeds the training split "
            f"({len(train_samples)} samples); clamping to {batch_size}."
        )
    if batch_size % world != 0:
        batch_size = max((batch_size // world) * world, world)
        print(f"Warning: batch size rounded to {batch_size} "
              f"(must divide across {world} devices).")
    if (batch_size // world) % args.grad_accum != 0:
        print(f"Error: per-device batch {batch_size // world} must divide by "
              f"--grad_accum {args.grad_accum}")
        return 1

    stores = {}
    for name, samples in (
        ("train", train_samples), ("val", val_samples), ("test", test_samples)
    ):
        if not samples:
            print("Error: SplitCrosstalkDataset received no samples.")
            return 1
        stores[name] = TileStore(samples, jobs=args.cpu_jobs,
                                 cache_dir=args.cache_dir)
        print(f"SplitCrosstalkDataset created with {len(samples)} samples.")
    print("Dataloaders created for training, validation, and testing.")

    optim_cfg = OptimConfig(
        learning_rate=args.learning_rate, scheduler=args.learning_scheduler
    )
    train_cfg = TrainConfig(
        batch_size=batch_size, num_epochs=args.num_epochs,
        output_base=args.output_base, resume=args.resume,
        checkpoint_every=args.checkpoint_every, grad_accum=args.grad_accum,
    )

    image_size = int(stores["train"].tiles.shape[1])  # size the head from data

    def model_for(state_dict=None, process_group=None):
        # initialized on the CPU from the seed, so a run's initial weights
        # are the same on every device and every rank
        model = build_model(model_cfg, image_size=image_size,
                            process_group=process_group)
        if state_dict is None:
            init_model(model, torch.Generator().manual_seed(args.seed))
        else:
            model.load_state_dict(state_dict)
        return model.to(device)

    if primary:
        artifacts.write_architecture_txt(
            run_dir, torch_style_repr(model_cfg, image_size=image_size))
        print(f"Model architecture summary saved to {run_dir}/model_architecture.txt")
    # cross-replica BatchNorm over several ranks; one rank keeps torch's own
    state = init_train_state(model_for(process_group=group if multirank else None),
                             optim_cfg)

    # the test split counts too: the post-training evaluation uploads it
    # while the train and val copies are still resident
    split_bytes = sum(DeviceDataset.nbytes(s) for s in stores.values())
    if args.data_placement == "auto" and multirank:
        device_data = False  # each rank streams its own rows
    elif args.data_placement == "auto":
        budget = placement_budget(device)
        device_data = split_bytes <= budget
        print(f"Data placement auto: splits {split_bytes / 2**30:.3f} GiB, budget "
              f"{budget / 2**30:.3f} GiB (a quarter of the free device memory)")
    else:
        device_data = args.data_placement == "device"
    device_datasets = {}
    if device_data:
        print(f"Data placement: resident on {device_label(device)} "
              "(one upload, on-device batching)")
        device_datasets = {s: DeviceDataset(stores[s], device) for s in ("train", "val")}

    print("\nStarting training with validation...")
    with maybe_trace(args.profile):
        state, train_losses, val_losses = train_model(
            state, stores["train"], stores["val"], optim_cfg, train_cfg,
            run_dir, ts, compute_dtype=args.compute_dtype, seed=args.seed,
            resume=bool(args.resume), naming_batch_size=args.batch_size,
            device_data=(
                (device_datasets["train"], device_datasets["val"])
                if device_data else None
            ),
            process_group=group,
        )
    print("Training finished!")
    if not primary:
        # the final artifacts and the post-training evaluation (one
        # device, no collectives) belong to rank 0
        return 0

    def store_for(split):
        if device_data:
            return device_datasets.get(split) or DeviceDataset(stores[split], device)
        return stores[split]

    finish_training_run(
        model_for, state, run_dir, args.batch_size, args.learning_rate,
        store_for, eval_batch_size=min(batch_size, 256),
        train_losses=train_losses, val_losses=val_losses,
        compute_dtype=args.compute_dtype,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
