"""Predict CLI (port of crosstalk_tpu/cli/predict.py): score UNLABELED
paired tiles with a trained checkpoint.

The reference's data paths require the ground-truth alpha in the filename
(reference train_model.py:105), so it cannot score new acquisitions. This
CLI pairs tiles by filename stem instead (``foo_mixed.tif`` <->
``foo_source.tif``, ``scan3-bleed.tiff`` <-> ``scan3-source.tiff``, or
identical names in both dirs; the labeled schema pairs too) and writes
per-pair predicted alphas:

    # local checkpoint, on the CUDA card (--device cpu for the CPU)
    python -m crosstalk_tpu_torch.cli.predict -m MIXED_DIR -s SOURCE_DIR -p model.pth
    # or an AOT artifact (tools/export_model): no model code, no checkpoint
    python -m crosstalk_tpu_torch.cli.predict -m MIXED_DIR -s SOURCE_DIR --artifact m.ctkt
    # or against a running server (cli/serve.py): no weights or card here
    python -m crosstalk_tpu_torch.cli.predict -m MIXED_DIR -s SOURCE_DIR \\
        --url http://gpu-host:8000

Output: ``predict_run_{ts}/`` with ``params.txt`` and
``predictions_{ts}.csv`` (``Image_Key,Mixed_File,Source_File,
Predicted_Alpha,Num_Tiles,Alpha_Std``). Local inference is float32
checkpoint parity (TF32 off) by default; ``--fast`` runs the folded-BN bf16
forward with block 0 in the fused CUDA input-block kernel; ``--int8`` the
opt-in int8 tier (self-calibrated on the first <=256 input tiles, block 0
in the same kernel); ``--artifact`` an exported program. ``--num_devices
N`` (default: every visible card; 1 with ``--device cpu``) scores over a
replica set: one replica of the forward per card, each batch padded to a
multiple of N and split between them. Remote mode ships tiles over the
serving wire (float16 payloads by default). For LABELED directories scored
against a server, see cli/remote_eval.py.

**Whole-image mode**: acquisitions LARGER than the model's native tile size
(from the checkpoint or the server's health) are gridded into native-size
crops, each crop is scored, and the per-tile alphas are aggregated per
image (``--aggregate median|mean``, spread reported as ``Alpha_Std``).
``--unmix`` then corrects the FULL image with the aggregated alpha.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Predict cross-talk alphas for unlabeled paired tiles."
    )
    parser.add_argument("-m", "--mixed_channel_data_dir", type=str,
                        required=True, help="Directory for mixed channel data")
    parser.add_argument("-s", "--pure_source_data_dir", type=str,
                        required=True, help="Directory for pure source data")
    parser.add_argument("-p", "--model_path", type=str, default=None,
                        help="Path to the trained .pth checkpoint "
                             "(local inference; exactly one of -p/--url)")
    parser.add_argument("--url", type=str, default=None,
                        help="Base URL of a running crosstalk server "
                             "(remote inference; exactly one of -p/--url)")
    parser.add_argument("--artifact", type=str, default=None,
                        help="AOT serving artifact (from "
                             "crosstalk_tpu_torch.tools.export_model): local "
                             "inference with no model code or checkpoint, "
                             "on the device type it was exported for")
    parser.add_argument("--request_tiles", type=int, default=64,
                        help="Remote mode: tiles per HTTP request (must be "
                             "within the server's --max_tiles)")
    parser.add_argument("--dtype", type=str, default="float16",
                        choices=["float16", "float32"],
                        help="Remote mode: payload dtype; float16 halves "
                             "the upload with ~1e-3 alpha perturbation")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="Remote mode: per-request timeout, seconds")
    parser.add_argument("-o", "--model_options", type=str, default="single",
                        choices=["single", "double"],
                        help="Use single- or double-branch model")
    parser.add_argument("-j", "--cpu_jobs", type=int, default=4,
                        help="TIFF-decode threads")
    parser.add_argument("-b", "--batch_size", type=int, default=64,
                        help="Device batch size for inference")
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override — must match the checkpoint")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override — must match the "
                             "checkpoint")
    parser.add_argument("--compute_dtype", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="f32 = checkpoint-parity mode (default); "
                             "bf16 = bf16 autocast")
    parser.add_argument("--fast", action="store_true",
                        help="Use the bf16 serving path (folded-BN forward "
                             "with the fused CUDA input block)")
    parser.add_argument("--int8", action="store_true",
                        help="Use the opt-in int8 tier (prediction error "
                             "OUTSIDE the 1e-4 parity budget). Activation "
                             "ranges self-calibrate on the first <=256 input "
                             "tiles")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Data-parallel device count for local inference "
                             "(default: every visible card; 1 with --device cpu)")
    parser.add_argument("--output_base", type=str, default=".",
                        help="Where to create the predict_run_* directory")
    parser.add_argument("--aggregate", type=str, default="median",
                        choices=["median", "mean"],
                        help="Whole-image mode: how per-tile alphas combine "
                             "into the image's alpha")
    parser.add_argument("--unmix", action="store_true",
                        help="Also write crosstalk-CORRECTED mixed tiles "
                             "(mixed - alpha*source, clipped at 0, float32 "
                             "TIFF) into predict_run_*/unmixed/")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Local and artifact modes: run on the CUDA card "
                             "(default) or the CPU")
    return parser


def _prepare_local(args):
    """-> (native_px, compat(px) -> bool, score_fn((m, px, px, 2)) -> (m,)),
    or None on error. Local checkpoint inference."""
    import numpy as np

    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.io.torch_convert import (
        image_size_compatible,
        infer_image_size,
        load_pth,
        model_config_for_checkpoint,
    )
    from crosstalk_tpu_torch.parallel.mesh import data_mesh, visible_devices
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    device = resolve_device(args.device)  # raises when CUDA is missing
    visible = visible_devices(device.type)
    n_dev = args.num_devices
    if n_dev is None:
        n_dev = visible if device.type == "cuda" else 1
    if n_dev <= 0 or n_dev > visible:
        print(f"Error: --num_devices {n_dev} requested but only "
              f"{visible} device(s) are visible.")
        return None
    devices = data_mesh(n_dev, device.type)
    print(f"Using device: {device_label(device)} x{n_dev}")

    print("\n--- Loading model weights ---")
    try:
        state_dict = load_pth(args.model_path)
        model_cfg = model_config_for_checkpoint(
            args.model_options, state_dict,
            initial_filters=args.initial_filters,
            num_conv_blocks=args.num_conv_blocks,
            compute_dtype=args.compute_dtype,
        )
        px = infer_image_size(state_dict, args.model_options)
    except (FileNotFoundError, KeyError, ValueError) as e:
        print(f"Error loading model from {args.model_path}: {e}")
        return None

    def score(tiles):
        m, h, w, _ = tiles.shape
        # one batch shape, no larger than needed; padded rows sliced off
        eff_batch = min(args.batch_size, m)
        eff_batch += (-eff_batch) % n_dev  # an equal row block per replica
        int8_scales = None
        if args.int8:
            # self-calibration: the input tiles ARE the serving
            # distribution, so activation ranges come from a prefix of them
            import torch

            from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
            from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8

            calib = normalize_batch_nhwc(torch.from_numpy(tiles[: min(256, m)]).to(device))
            print(f"Calibrating int8 activation ranges on {calib.shape[0]} tiles...")
            int8_scales = calibrate_int8(
                model_cfg, {k: v.to(device) for k, v in state_dict.items()}, calib)
        predict = make_predictor(
            state_dict, model_cfg, batch_size=eff_batch, image_size=h,
            fast=args.fast or args.int8, warmup=False,
            int8_scales=int8_scales, devices=devices,
        )
        preds = np.empty((m,), dtype=np.float32)
        for start in range(0, m, eff_batch):
            chunk = tiles[start:start + eff_batch]
            real = chunk.shape[0]
            if real < eff_batch:
                pad = np.zeros((eff_batch - real, h, w, 2), dtype=np.float32)
                chunk = np.concatenate([chunk, pad], axis=0)
            preds[start:start + real] = predict(chunk)[:real]
        return preds

    # Pooling floors odd dims, so sizes that are not multiples of 2**pools
    # share the detected head shape; accept any of them as native.
    def compat(size):
        return image_size_compatible(state_dict, args.model_options, size)

    return px, compat, score


def _prepare_artifact(args):
    """-> (native_px or None, compat, score_fn) or None on error. Inference
    with an AOT artifact: torch alone, no model code, no checkpoint. A
    pinned-batch artifact dictates its chunk size."""
    import numpy as np

    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.io.export import load_exported

    device = resolve_device(args.device)  # raises when CUDA is missing
    print("--- Loading AOT artifact ---")
    try:
        fn, meta = load_exported(args.artifact, device=args.device)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error loading artifact {args.artifact}: {e}")
        return None
    print(f"Using device: {device_label(device)} x1")
    px = meta.get("image_size")
    px = int(px) if px is not None else None
    meta_bs = meta.get("batch_size", "dynamic")
    print(f"Artifact: batch {meta_bs}, {meta.get('path', '?')} path")

    def score(tiles):
        m, h, w, _ = tiles.shape
        eff_batch = min(args.batch_size, m) if meta_bs == "dynamic" else int(meta_bs)
        preds = np.empty((m,), dtype=np.float32)
        for start in range(0, m, eff_batch):
            chunk = np.asarray(tiles[start:start + eff_batch], np.float32)
            real = chunk.shape[0]
            if real < eff_batch and meta_bs != "dynamic":
                pad = np.zeros((eff_batch - real, h, w, 2), dtype=np.float32)
                chunk = np.concatenate([chunk, pad], axis=0)
            preds[start:start + real] = fn(chunk)[:real]
        return preds

    return px, (lambda size: px is None or size == px), score


def _prepare_remote(args):
    """-> (native_px or None, compat, score_fn) or None on error. Inference
    by a running crosstalk server over the serving wire."""
    import numpy as np

    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    client = CrosstalkClient(args.url, timeout=args.timeout)
    try:
        health = client.health()
    except Exception as e:
        print(f"Error: server at {args.url} is not reachable: {e}")
        return None
    print(f"Server: {health}")
    px = health.get("image_size")
    px = int(px) if px is not None else None

    def score(tiles):
        m = tiles.shape[0]
        preds = np.empty((m,), dtype=np.float32)
        for start in range(0, m, args.request_tiles):
            stop = min(start + args.request_tiles, m)
            try:
                preds[start:stop] = client.predict(
                    np.asarray(tiles[start:stop], np.float32),
                    dtype=args.dtype,
                )
            except Exception as e:
                print(f"Error: prediction request failed at rows "
                      f"{start}:{stop}: {e}")
                return None
            print(f"  {stop}/{m} tiles scored", end="\r", flush=True)
        print()
        return preds

    return px, (lambda size: px is None or size == px), score


def _grid_images(images, px):
    """(n, H, W, 2) -> (n*k, px, px, 2) non-overlapping px-grid crops,
    top-left anchored; returns (crops, tiles_per_image). Margins beyond the
    last full tile are discarded (each crop is min-max normalized
    independently by the forward, matching training semantics)."""
    import numpy as np

    n, h, w, c = images.shape
    gh, gw = h // px, w // px
    trimmed = images[:, : gh * px, : gw * px, :]
    crops = np.ascontiguousarray(
        trimmed.reshape(n, gh, px, gw, px, c)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(n * gh * gw, px, px, c)
    )
    return crops, gh * gw


def _check_flags(args):
    """-> an error message for a bad flag, or None."""
    if sum(x is not None for x in (args.model_path, args.url, args.artifact)) != 1:
        return ("Error: exactly one of -p/--model_path (local checkpoint), "
                "--artifact (local AOT artifact), or --url (remote server) "
                "is required.")
    if args.url is not None and args.request_tiles <= 0:
        return f"Error: --request_tiles must be positive, got {args.request_tiles}"
    if args.batch_size <= 0:
        return f"Error: --batch_size must be positive, got {args.batch_size}"
    if args.int8 and args.model_path is None:
        return ("Error: --int8 requires a local checkpoint (-p); servers "
                "choose their own tier (--quantize on cli/serve) and AOT "
                "artifacts carry theirs from export time "
                "(tools/export_model --quantize int8).")
    if args.int8 and args.fast:
        return ("Error: --int8 and --fast are distinct serving tiers — pass "
                "exactly one.")
    if args.int8 and args.model_options == "double":
        return ("Error: --int8 is gated to the single-branch family, as in the "
                "JAX package. Use --fast instead.")
    if args.num_devices is not None and args.num_devices != 1 and args.model_path is None:
        return ("Error: --num_devices > 1 requires a checkpoint (-p); AOT "
                "artifacts are traced for one device, and a server (--url) "
                "chooses its own (serve --num_devices).")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    error = _check_flags(args)
    if error:
        print(error)
        return 1

    import numpy as np

    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.io import artifacts

    try:
        index = pair_unlabeled(args.mixed_channel_data_dir,
                               args.pure_source_data_dir)
    except (ValueError, FileNotFoundError) as e:
        print(f"Error pairing tiles: {e}")
        return 1
    samples = index.samples
    print(f"Paired {len(samples)} tile pairs.")
    for role, unpaired in (("mixed", index.unpaired_mixed),
                           ("source", index.unpaired_source)):
        if unpaired:
            shown = ", ".join(unpaired[:5])
            more = f", ... ({len(unpaired)} total)" if len(unpaired) > 5 else ""
            print(f"Warning: {len(unpaired)} unpaired {role} file(s) "
                  f"skipped: {shown}{more}")

    print("\n--- Decoding tiles ---")
    try:
        images = load_tiles(samples, jobs=args.cpu_jobs)
    except (ValueError, OSError) as e:
        print(f"Error decoding tiles: {e}")
        return 1
    n, h, w, _ = images.shape

    if args.url is not None:
        prep = _prepare_remote(args)
    elif args.artifact is not None:
        prep = _prepare_artifact(args)
    else:
        prep = _prepare_local(args)
    if prep is None:
        return 1
    px, compat, score = prep
    if px is None:  # size not recorded anywhere: inputs must BE the tiles
        if h != w:
            print(f"Error: tiles must be square, got {h}x{w} (the model's "
                  "tile size is not recorded, so images cannot be gridded).")
            return 1
        px = h

    if h == w and compat(h):
        tile_batch, k = images, 1
    else:
        # Whole-image mode: alpha is a property of the channel pair, so a
        # large acquisition is scored as a grid of native-size tiles and
        # aggregated per image.
        if h < px or w < px:
            print(f"Error: images are {h}x{w} but the model scores {px}px "
                  f"tiles — images must be at least {px}px in each dim.")
            return 1
        tile_batch, k = _grid_images(images, px)
        dropped = (h % px, w % px)
        margin = (f"; {dropped[0]}x{dropped[1]}px margins discarded"
                  if any(dropped) else "")
        print(f"\nGridding {h}x{w} images into {k} {px}px tiles each, "
              f"aggregating per image by {args.aggregate}{margin}")

    print("\n--- Predicting ---")
    tile_preds = score(tile_batch)
    if tile_preds is None:
        return 1
    per_image = tile_preds.reshape(n, k)
    agg = (np.median if args.aggregate == "median" else np.mean)
    preds = agg(per_image, axis=1).astype(np.float32)
    stds = per_image.std(axis=1).astype(np.float32)

    ts = artifacts.timestamp()
    output_dir = artifacts.make_predict_run_dir(args.output_base, ts)
    artifacts.write_params_txt(output_dir, vars(args))
    fieldnames = ["Image_Key", "Mixed_File", "Source_File",
                  "Predicted_Alpha", "Num_Tiles", "Alpha_Std"]
    rows = [
        {
            "Image_Key": s.image_id,
            "Mixed_File": os.path.basename(s.mixed_path),
            "Source_File": os.path.basename(s.source_path),
            "Predicted_Alpha": f"{float(p):.6f}",
            "Num_Tiles": k,
            "Alpha_Std": f"{float(sd):.6f}",
        }
        for s, p, sd in zip(samples, preds, stds)
    ]
    csv_path = artifacts.write_predictions_csv(
        os.path.join(output_dir, f"predictions_{ts}.csv"), rows, fieldnames
    )
    print(f"Predictions for {n} pairs saved to {csv_path}")

    if args.unmix:
        # mixed = signal + alpha*source in RAW intensity space (reference
        # README.md:5), so the correction subtracts there too; negative
        # residuals are prediction-error noise and are clipped at 0
        from crosstalk_tpu_torch.data.tiff import write_tile

        unmix_dir = os.path.join(output_dir, "unmixed")
        os.makedirs(unmix_dir, exist_ok=True)
        for i, s in enumerate(samples):
            corrected = np.clip(
                images[i, :, :, 0] - float(preds[i]) * images[i, :, :, 1],
                0.0, None,
            ).astype(np.float32)
            write_tile(
                os.path.join(unmix_dir, f"{s.image_id}_unmixed.tif"),
                corrected,
            )
        print(f"Crosstalk-corrected tiles for {n} pairs saved to {unmix_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
