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
The data-parallel and multi-host flags (``--num_devices`` > 1,
``--multihost``, ``--coordinator_address``, ``--num_processes``,
``--process_id``), ``--profile`` and ``--debug_nans`` are not ported yet
and are rejected.
"""

from __future__ import annotations

import argparse
import glob
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
                        help="Existing training_run_* directory to resume from")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Data-parallel device count (only 1 so far)")
    parser.add_argument("--seed", type=int, default=43,
                        help="Split/init/augmentation seed (reference: 43)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Not available in this package yet")
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
                             "must divide by N")
    parser.add_argument("--data_placement", type=str, default="auto",
                        choices=["auto", "host", "device"],
                        help="'device' keeps the splits resident on the card "
                             "(one upload, no per-step host-to-device copy); "
                             "'host' streams batches from host memory; "
                             "'auto' picks device on a CUDA card when all "
                             "three splits take at most a quarter of its "
                             "free memory, else host")
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="Directory for the packed decoded-tile cache "
                             "(memory-mapped; repeat runs skip TIFF decode)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Not available in this package yet")
    parser.add_argument("--multihost", action="store_true",
                        help="Not available in this package yet")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="Not available in this package yet")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Not available in this package yet")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Not available in this package yet")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Run on the CUDA card (default) or the CPU")
    return parser


def _unported_flag(args) -> str:
    """The first given flag whose slice has not landed, or ''."""
    if args.num_devices not in (None, 1):
        return (f"--num_devices {args.num_devices}: this package trains on "
                "one device only so far")
    for flag, value in (("--multihost", args.multihost),
                        ("--coordinator_address", args.coordinator_address),
                        ("--num_processes", args.num_processes),
                        ("--process_id", args.process_id)):
        if value is not None and value is not False:
            return f"{flag}: multi-host training is not available in this package yet"
    for flag, value in (("--debug_nans", args.debug_nans),
                        ("--profile", args.profile)):
        if value:
            return (f"{flag} is not available in this package yet "
                    "(utils/profiling.py is not ported)")
    return ""


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
    unported = _unported_flag(args)
    if unported:
        print(f"Error: {unported}.")
        return 1

    import torch

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
    from crosstalk_tpu_torch.data.index import PairIndex, split_samples
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore
    from crosstalk_tpu_torch.device import (
        device_label,
        resolve_device,
        set_parity_numerics,
    )
    from crosstalk_tpu_torch.io import artifacts
    from crosstalk_tpu_torch.models.registry import (
        build_model,
        init_model,
        torch_style_repr,
    )
    from crosstalk_tpu_torch.train.loop import finish_training_run, train_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    device = resolve_device(args.device)  # raises when CUDA is missing
    set_parity_numerics()
    print(f"Using device: {device_label(device)} x1")

    if args.resume:
        # A resumed run continues the SAME run: the hyperparameters that
        # define it (naming, split, schedule, model) come from the original
        # params.txt, not this invocation's flags/defaults. -n stays from the
        # invocation: it is the (extendable) total-epoch target.
        original = artifacts.read_params_txt(args.resume)
        if not glob.glob(os.path.join(args.resume, "checkpoints", "*")):
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
    else:
        ts = artifacts.timestamp()
        run_dir = artifacts.make_training_run_dir(
            args.output_base, ts, args.batch_size, args.learning_rate
        )
    print(f"Saving all outputs to: {run_dir}")

    # on resume, params.txt is the ORIGINAL run's record: keep it and log
    # the resume invocation separately
    if args.resume:
        artifacts.write_params_txt(run_dir, vars(args), filename="params_resume.txt")
        print(f"Resume parameters saved to {run_dir}/params_resume.txt")
    else:
        artifacts.write_params_txt(run_dir, vars(args))
        print(f"Parameters saved to {run_dir}/params.txt")

    # Quickstart bootstrap: the reference bundles Training_Data/ (100 paired
    # tiles) so its zero-flag `python train_model.py` just works. When both
    # data flags are at their defaults and the directory is absent, generate
    # an equivalent 100-pair sample set there once (data/synthetic.py).
    if (args.mixed_channel_data_dir == "./Training_Data/Mixed"
            and args.pure_source_data_dir == "./Training_Data/Source"
            and not os.path.isdir(args.mixed_channel_data_dir)):
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

    batch_size = args.batch_size
    if batch_size > len(train_samples):
        batch_size = max(len(train_samples), 1)
        print(
            f"Warning: batch size {args.batch_size} exceeds the training split "
            f"({len(train_samples)} samples); clamping to {batch_size}."
        )
    if batch_size % args.grad_accum != 0:
        print(f"Error: per-device batch {batch_size} must divide by "
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

    def model_for(state_dict=None):
        # initialized on the CPU from the seed, so a run's initial weights
        # are the same on every device
        model = build_model(model_cfg, image_size=image_size)
        if state_dict is None:
            init_model(model, torch.Generator().manual_seed(args.seed))
        else:
            model.load_state_dict(state_dict)
        return model.to(device)

    artifacts.write_architecture_txt(
        run_dir, torch_style_repr(model_cfg, image_size=image_size))
    print(f"Model architecture summary saved to {run_dir}/model_architecture.txt")
    state = init_train_state(model_for(), optim_cfg)

    # the test split counts too: the post-training evaluation uploads it
    # while the train and val copies are still resident
    split_bytes = sum(DeviceDataset.nbytes(s) for s in stores.values())
    if args.data_placement == "auto":
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
    state, train_losses, val_losses = train_model(
        state, stores["train"], stores["val"], optim_cfg, train_cfg,
        run_dir, ts, compute_dtype=args.compute_dtype, seed=args.seed,
        resume=bool(args.resume), naming_batch_size=args.batch_size,
        device_data=(
            (device_datasets["train"], device_datasets["val"])
            if device_data else None
        ),
    )
    print("Training finished!")

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
