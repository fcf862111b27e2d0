"""Export a .pth checkpoint as a self-contained serving artifact (port of
tools/export_model.py).

    python -m crosstalk_tpu_torch.tools.export_model -p model.pth [-o single]
        [--out model.ctkt] [--batch_size 256] [--platforms cuda cpu] [--parity]
        [--quantize int8 --calibration_mixed_dir M --calibration_source_dir S]

The artifact (``io/export.py`` format) carries one ``torch.export`` program
per device type of ``--platforms`` (default ``cuda cpu``, as the JAX tool
lowers for ``tpu cpu``), each traced on its own type, with one shared
weights section and the normalization, and a symbolic batch dimension by
default (``--batch_size`` pins one static shape). ``--device X`` is the
one-platform spelling, ``--platforms X``. A ``cuda`` program is traced on a
card: without one, asking for ``cuda`` raises. The int8 tier's clips are
calibrated once, on the card when ``cuda`` is among the platforms, and
shared by the programs. It loads with torch alone:

    from crosstalk_tpu_torch.io.export import load_exported
    fn, meta = load_exported("model.ctkt")                # the card's program
    fn, meta = load_exported("model.ctkt", device="cpu")  # the CPU's
    alphas = fn(tiles)          # (batch, 256, 256, 2) float32 -> (batch,)
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-p", "--model_path", required=True,
                    help=".pth checkpoint to export")
    ap.add_argument("-o", "--model_options", default="single",
                    choices=["single", "double"])
    ap.add_argument("--initial_filters", type=int, default=None,
                    help="Model width override — must match the checkpoint "
                         "(reference config: 128 single / 64 per branch)")
    ap.add_argument("--num_conv_blocks", type=int, default=None,
                    help="Single-branch depth override — must match the "
                         "checkpoint (reference: 6)")
    ap.add_argument("--out", default=None,
                    help="Output path (default: <model_path>.ctkt)")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="Pin one static batch shape (default: dynamic — "
                         "the artifact accepts any batch size)")
    ap.add_argument("--image_size", type=int, default=None,
                    help="Tile height/width (default: auto-detected from "
                         "the checkpoint's head dimensions)")
    ap.add_argument("--platforms", nargs="+", default=None, choices=["cuda", "cpu"],
                    help="Device types to trace a program for (default: "
                         "cuda cpu); the artifact loads on each of them")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="One device type to trace for: --device X is "
                         "--platforms X")
    ap.add_argument("--parity", action="store_true",
                    help="Export the f32 parity forward instead of the "
                         "bf16 serving path")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="Export the opt-in int8 tier instead of bf16 "
                         "(prediction error OUTSIDE the 1e-4 parity budget). "
                         "The calibrated activation clips are part of the "
                         "program, so the deployment site needs no "
                         "calibration data. Requires the --calibration_* "
                         "dirs; incompatible with --parity")
    ap.add_argument("--calibration_mixed_dir", default=None,
                    help="--quantize int8: directory of mixed-channel tiles "
                         "from the serving distribution (paired with "
                         "--calibration_source_dir by filename)")
    ap.add_argument("--calibration_source_dir", default=None,
                    help="--quantize int8: directory of pure-source tiles "
                         "paired with --calibration_mixed_dir")
    ap.add_argument("--calibration_tiles", type=int, default=256,
                    help="--quantize int8: max tile pairs used for "
                         "activation-range calibration")
    return ap


def _check_flags(args):
    """-> an error message for bad or conflicting flags, or None."""
    if args.batch_size is not None and args.batch_size <= 0:
        return f"Error: --batch_size must be positive, got {args.batch_size}"
    if args.quantize is not None:
        if args.parity:
            return ("Error: --quantize int8 and --parity are mutually exclusive "
                    "(int8 is far outside the parity budget).")
        if args.model_options == "double":
            return ("Error: --quantize int8 is gated to the single-branch "
                    "family, as in the JAX package. Export the default bf16 "
                    "tier instead.")
        if not (args.calibration_mixed_dir and args.calibration_source_dir):
            return ("Error: --quantize int8 requires --calibration_mixed_dir and "
                    "--calibration_source_dir (tiles from the serving "
                    "distribution to calibrate activation ranges on).")
        if args.calibration_tiles <= 0:
            return (f"Error: --calibration_tiles must be positive, got "
                    f"{args.calibration_tiles}")
    elif args.calibration_mixed_dir or args.calibration_source_dir:
        return "Error: --calibration_* dirs only apply with --quantize int8."
    if args.num_conv_blocks is not None and args.model_options == "double":
        return "Error: --num_conv_blocks applies to the single-branch model only."
    if args.device is not None and args.platforms not in (None, [args.device]):
        return (f"Error: --device {args.device} is --platforms {args.device}; it "
                f"conflicts with --platforms {' '.join(args.platforms)}.")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    error = _check_flags(args)
    if error:
        print(error)
        return 1

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.device import resolve_device
    from crosstalk_tpu_torch.io.export import (
        BLOCK0_NOTE,
        PLATFORMS,
        default_device,
        export_serving_programs,
        save_exported,
    )
    from crosstalk_tpu_torch.io.torch_convert import (
        compatible_px_range,
        image_size_compatible,
        infer_image_size,
        infer_model_size,
        load_pth,
        model_config_for_checkpoint,
    )

    platforms = args.platforms or ([args.device] if args.device else list(PLATFORMS))
    for p in platforms:
        resolve_device(p)  # raises when CUDA is missing
    # the int8 clips are calibrated once, on the device the artifact serves on
    # by default, and shared by the programs
    device = resolve_device(default_device(platforms))
    variant = args.model_options
    compute_dtype = "f32" if args.parity else "bf16"
    try:
        state_dict = load_pth(args.model_path)
        cfg = model_config_for_checkpoint(
            variant, state_dict, initial_filters=args.initial_filters,
            num_conv_blocks=args.num_conv_blocks, compute_dtype=compute_dtype)
        detected_px = infer_image_size(state_dict, variant)
    except (FileNotFoundError, KeyError, ValueError) as e:
        print(f"Error loading model from {args.model_path}: {e}")
        return 1
    if cfg != ModelConfig(variant=variant, compute_dtype=compute_dtype):
        print(f"Detected non-default model size from the checkpoint: {cfg}")
    image_size = args.image_size
    if image_size is None:
        image_size = detected_px
        if detected_px != 256:
            print(f"Detected tile size from the checkpoint: {detected_px}px")
    elif not image_size_compatible(state_dict, variant, image_size):
        lo, hi = compatible_px_range(state_dict, variant)
        print(f"Error: --image_size {image_size} does not match the "
              f"checkpoint's head (compatible tile sizes: {lo}-{hi}px).")
        return 1

    int8_scales = None
    extra = {}
    if args.quantize == "int8":
        from crosstalk_tpu_torch.eval.int8_forward import (
            calibrate_int8,
            load_calibration_tiles,
        )

        try:
            calib = load_calibration_tiles(
                args.calibration_mixed_dir, args.calibration_source_dir,
                image_size, max_tiles=args.calibration_tiles)
        except (ValueError, FileNotFoundError, OSError) as e:
            print(f"Error loading calibration tiles: {e}")
            return 1
        print(f"Calibrating int8 activation ranges on {calib.shape[0]} tile pairs...")
        # on the exported program's route: block 0 on the bf16 conv path
        int8_scales = calibrate_int8(
            cfg, {k: v.to(device) for k, v in state_dict.items()}, calib,
            use_kernel=False)
        extra = {"calibration_tiles": int(calib.shape[0]), "int8_scales": int8_scales}

    path = "parity" if args.parity else args.quantize or "fast"
    batch = "dynamic" if args.batch_size is None else args.batch_size
    print(f"Exporting for {', '.join(platforms)} (batch {batch}, {image_size}px, "
          f"{path} path)...")
    programs, weights = export_serving_programs(
        state_dict, cfg, args.batch_size, image_size=image_size,
        fast=not args.parity, platforms=platforms, int8_scales=int8_scales)
    out = args.out or args.model_path + ".ctkt"
    save_exported(out, programs, weights, {
        "model_options": variant,
        **infer_model_size(state_dict, variant),
        "checkpoint": os.path.basename(args.model_path),
        "batch_size": batch,
        "image_size": image_size,
        "path": path,
        "block0": BLOCK0_NOTE,
        **extra,
    })
    print(f"Wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
