"""Evaluation CLI (port of crosstalk_tpu/cli/evaluate.py): the reference's
``test-cross-talk-model.py`` surface (flags and defaults:
test-cross-talk-model.py:228-242; behavior: 255-324).

Scores every paired tile in the given directories with a ``.pth``
checkpoint, computes the five classical comparison metrics, and writes the
``eval_run_{ts}/`` artifact set (params.txt, model_architecture.txt,
test_predictions_{ts}.csv, one scatter PNG per metric).

    python -m crosstalk_tpu_torch.cli.evaluate -m MIXED -s SOURCE -p model.pth [--fast]

Runs on the CUDA card (``--device cpu`` to run on the CPU explicitly).
The default is the float32 parity mode, with TF32 off; ``--fast`` runs the
folded-BN bf16 forward with block 0 in the fused CUDA kernel.
``--num_devices N`` (default: every visible card; 1 with ``--device cpu``)
evaluates over a replica set: one replica of the forward per card, each
batch split between them (``parallel.replicated_forward``), where the JAX
CLI shards one program over a mesh. ``--profile DIR`` writes a
``torch.profiler`` trace of the evaluation; ``--debug_nans`` fails on the
first NaN or Inf.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Script for training with various parameters."
    )
    parser.add_argument(
        "-m", "--mixed_channel_data_dir", type=str,
        default="/nemo/stp/lm/working/barryd/IDR/crosstalk_training_data/bleed",
        help="Directory for mixed channel data",
    )
    parser.add_argument(
        "-s", "--pure_source_data_dir", type=str,
        default="/nemo/stp/lm/working/barryd/IDR/crosstalk_training_data/source",
        help="Directory for pure source data",
    )
    parser.add_argument(
        "-p", "--model_path", type=str,
        default=(
            "/nemo/stp/lm/working/barryd/hpc/python/Torch-Unet/"
            "training_run_2025-12-15_16-02-16_B256_LR0.0005/"
            "crosstalk_regression_model_trained_2025-12-15_18-22-01_256_0.0005.pth"
        ),
        help="Path to pytorch model",
    )
    parser.add_argument("-j", "--cpu_jobs", type=int, default=20,
                        help="Number of CPUs to use")
    parser.add_argument("-o", "--model_options", type=str, default="single",
                        help="Use single- or double-branch model, or SwinV2-B "
                             "(swinv2-b)",
                        choices=["single", "double", "swinv2-b"])
    # Extensions beyond the reference surface:
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override — must match the "
                             "checkpoint (reference config: 128 single / "
                             "64 per branch double)")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override — must match "
                             "the checkpoint (reference: 6)")
    parser.add_argument("--compute_dtype", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="f32 = checkpoint-parity mode (default); "
                             "bf16 = bf16 autocast")
    parser.add_argument("--batch_size", type=int, default=64,
                        help="Device batch size for inference")
    parser.add_argument("--output_base", type=str, default=".",
                        help="Where to create the eval_run_* directory")
    parser.add_argument("--fast", action="store_true",
                        help="Use the bf16 serving path (folded-BN forward "
                             "with the fused CUDA input block)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Data-parallel device count for inference "
                             "(default: every visible card; 1 with --device cpu)")
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="Directory for the packed decoded-tile cache "
                             "(memory-mapped; repeat runs skip TIFF decode)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Fail fast on NaN/Inf (note: a genuinely constant "
                             "tile yields NaN correlation metrics by reference "
                             "semantics and will trip this)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of the evaluation "
                             "to DIR")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Run on the CUDA card (default) or the CPU")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.batch_size <= 0:
        print(f"Error: --batch_size must be positive, got {args.batch_size}")
        return 1
    if args.num_conv_blocks is not None and args.model_options == "double":
        print("Error: --num_conv_blocks applies to the single-branch model "
              "only (the two-branch trunk is fixed at 4 blocks per branch).")
        return 1
    if args.fast and args.model_options == "swinv2-b":
        print("Error: --fast (folded BatchNorm, kernel K1) runs the conv models "
              "only, not swinv2-b; evaluate it without --fast.")
        return 1

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.data.tiff import read_tile
    from crosstalk_tpu_torch.device import (
        device_label,
        resolve_device,
        set_parity_numerics,
    )
    from crosstalk_tpu_torch.eval.engine import evaluate_and_save, model_forward
    from crosstalk_tpu_torch.io import artifacts
    from crosstalk_tpu_torch.io.torch_convert import (
        load_pth,
        model_config_for_checkpoint,
    )
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.parallel.mesh import (
        data_mesh,
        replicated_forward,
        visible_devices,
    )
    from crosstalk_tpu_torch.utils.profiling import enable_debug_checks, maybe_trace

    device = resolve_device(args.device)  # raises when CUDA is missing
    if args.debug_nans:
        enable_debug_checks()
    set_parity_numerics()
    visible = visible_devices(device.type)
    n_dev = args.num_devices
    if n_dev is None:
        n_dev = visible if device.type == "cuda" else 1
    if n_dev <= 0 or n_dev > visible:
        print(f"Error: --num_devices {n_dev} requested but only "
              f"{visible} device(s) are visible.")
        return 1
    devices = data_mesh(n_dev, device.type)
    print(f"Using device: {device_label(device)} x{n_dev}")

    ts = artifacts.timestamp()
    output_dir = artifacts.make_eval_run_dir(args.output_base, ts)
    print(f"Saving all outputs to: {output_dir}")

    artifacts.write_params_txt(output_dir, vars(args))
    print(f"Parameters saved to {output_dir}/params.txt")

    print("\nCreating dataset instances for initial file listing...")
    try:
        index = PairIndex(args.mixed_channel_data_dir, args.pure_source_data_dir)
        print(f"Found {len(index)} matching samples.")
    except (ValueError, FileNotFoundError) as e:
        print(f"Error initializing temporary dataset: {e}")
        return 1

    print("\n--- Loading model weights ---")
    try:
        state_dict = load_pth(args.model_path)
        model_cfg = model_config_for_checkpoint(
            args.model_options, state_dict,
            initial_filters=args.initial_filters,
            num_conv_blocks=args.num_conv_blocks,
            compute_dtype=args.compute_dtype,
        )
    except (FileNotFoundError, KeyError, ValueError) as e:
        print(f"Error loading model from {args.model_path}: {e}")
        return 1
    if model_cfg != ModelConfig(variant=args.model_options,
                                compute_dtype=args.compute_dtype):
        print(f"Detected non-default model size from the checkpoint: "
              f"{model_cfg}")
    # size the head from the data, as the reference's dummy forward does
    image_size = int(read_tile(index.samples[0].mixed_path).shape[0])
    model = build_model(model_cfg, image_size=image_size, device=device)
    try:
        model.load_state_dict(state_dict)
    except RuntimeError as e:  # shape mismatch: tiles vs checkpoint size
        print(f"Error loading model from {args.model_path}: {e}")
        return 1
    artifacts.write_architecture_txt(output_dir, str(model))
    print(f"Model architecture summary saved to {output_dir}/model_architecture.txt")

    store = TileStore(index.samples, jobs=args.cpu_jobs,
                      cache_dir=args.cache_dir)

    def replica(d):
        # one copy of the weights per device; the fast path packs its K1
        # weights there (make_first_block)
        if args.fast:
            from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward

            return make_fast_forward(model_cfg, {k: v.to(d) for k, v in
                                                 model.state_dict().items()})
        if d == next(model.parameters()).device:
            return model_forward(model, args.compute_dtype)
        twin = build_model(model_cfg, image_size=image_size, device=d)
        twin.load_state_dict(model.state_dict())
        return model_forward(twin, args.compute_dtype)

    forward = replicated_forward(replica, devices)

    print("\n--- Evaluating Model ---")
    with maybe_trace(args.profile):
        evaluate_and_save(
            forward, store, devices[0],
            dataset_name="test", output_dir=output_dir, ts=ts,
            batch_size=args.batch_size, replicas=n_dev,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
