"""Serving CLI (port of crosstalk_tpu/cli/serve.py): online inference over
HTTP with dynamic batching.

Loads a ``.pth`` (or an AOT artifact, ``--artifact``), warms the serving
forward at every batch shape, and coalesces concurrent HTTP requests into
full device batches. The default path is the folded-BN bf16 forward with
block 0 in the fused CUDA input-block kernel; ``--parity`` serves the
float32 module with TF32 off; ``--quantize int8`` the opt-in int8 tier,
calibrated at startup (and again on every ``/reload``) on tiles from
``--calibration_mixed_dir``/``--calibration_source_dir``.

    python -m crosstalk_tpu_torch.cli.serve -p model.pth -o single --port 8000
    curl -s http://127.0.0.1:8000/healthz

Runs on the CUDA card (``--device cpu`` to run on the CPU explicitly).
``build_server`` constructs the server from parsed flags without serving
it; ``main`` serves until Ctrl-C or SIGTERM, then drains the queue.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve a crosstalk regression checkpoint over HTTP."
    )
    parser.add_argument("-p", "--model_path", type=str, default=None,
                        help="Path to the .pth checkpoint to serve")
    parser.add_argument("--artifact", type=str, default=None,
                        help="Serve an AOT artifact (crosstalk_tpu_torch."
                             "tools.export_model) instead of a checkpoint. Its "
                             "image size overrides the flags; dynamic-batch "
                             "artifacts (the export default) serve at "
                             "--batch_size, pinned ones dictate their own")
    parser.add_argument("-o", "--model_options", type=str, default="single",
                        choices=["single", "double"],
                        help="Use single- or double-branch model")
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override — must match the "
                             "checkpoint (reference config: 128 single / "
                             "64 per branch double)")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override — must match "
                             "the checkpoint (reference: 6)")
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="Bind address (0.0.0.0 to accept remote traffic)")
    parser.add_argument("--port", type=int, default=8000,
                        help="Bind port (0 picks a free port)")
    parser.add_argument("--batch_size", type=int, default=256,
                        help="Device batch size; requests are coalesced and "
                             "padded to exactly this shape")
    parser.add_argument("--batch_buckets", type=str, default=None,
                        help="Comma-separated extra batch shapes below "
                             "--batch_size (e.g. '32,128'). A partially-"
                             "filled flush dispatches at the smallest "
                             "bucket that holds it, so light traffic pays "
                             "a small device call + transfer instead of a "
                             "full batch_size one. Each bucket is warmed up "
                             "at startup. Requires -p")
    parser.add_argument("--max_delay_ms", type=float, default=5.0,
                        help="Max time a queued tile waits for a full batch")
    parser.add_argument("--image_size", type=int, default=None,
                        help="Tile height/width (default: auto-detected "
                             "from the checkpoint)")
    parser.add_argument("--parity", action="store_true",
                        help="Serve the f32 checkpoint-parity forward (TF32 "
                             "off) instead of the bf16 serving path")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="Serve the opt-in int8 tier instead of bf16 "
                             "(prediction error OUTSIDE the 1e-4 parity "
                             "budget). Requires -p and the --calibration_* "
                             "dirs; incompatible with --parity")
    parser.add_argument("--calibration_mixed_dir", type=str, default=None,
                        help="--quantize int8: directory of mixed-channel "
                             "tiles drawn from the serving distribution "
                             "(paired with --calibration_source_dir by "
                             "filename, labeled or unlabeled schema); the "
                             "activation ranges are calibrated on up to "
                             "--calibration_tiles of them at startup")
    parser.add_argument("--calibration_source_dir", type=str, default=None,
                        help="--quantize int8: directory of pure-source "
                             "tiles paired with --calibration_mixed_dir")
    parser.add_argument("--calibration_tiles", type=int, default=256,
                        help="--quantize int8: max tile pairs used for "
                             "activation-range calibration")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Device count (only 1 so far)")
    parser.add_argument("--request_timeout", type=float, default=120.0,
                        help="Per-request result timeout, seconds")
    parser.add_argument("--io_timeout", type=float, default=60.0,
                        help="Per-connection socket read timeout, seconds "
                             "(frees handler threads from clients that "
                             "stall mid-body or idle on keep-alive)")
    parser.add_argument("--transport_dtype", type=str, default="float32",
                        choices=["float32", "float16"],
                        help="Dtype of the assembled device batch. float16 "
                             "halves the host-to-device copy with ~1e-3 "
                             "alpha perturbation (the predictor upcasts on "
                             "the device). Pair with the client's "
                             "predict(dtype='float16') to halve the HTTP "
                             "wire too")
    parser.add_argument("--max_body_mb", type=int, default=256,
                        help="Reject request bodies above this many MiB "
                             "(memory-safety cap for public binds)")
    parser.add_argument("--max_tiles", type=int, default=4096,
                        help="Reject requests holding more than this many "
                             "decoded tiles")
    parser.add_argument("--allow_reload", action="store_true",
                        help="Enable POST /reload {\"model_path\": ...}: "
                             "zero-downtime checkpoint hot-swap (the new "
                             ".pth loads and warms up while the old model "
                             "keeps serving, then batches switch over "
                             "atomically). Loading a .pth unpickles it — "
                             "enable only on trusted/admin networks. "
                             "Requires -p (not --artifact)")
    parser.add_argument("--verbose", action="store_true",
                        help="Log each HTTP request")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Run on the CUDA card (default) or the CPU")
    return parser


class SetupError(Exception):
    """A user-facing startup error; ``main`` prints it and exits 1."""


def _check_flags(args) -> None:
    """Reject bad values and conflicting or not-yet-ported flags, before
    any weights load (the JAX serve CLI's checks, in its order)."""
    if not 0 <= args.port <= 65535:
        raise SetupError(f"Error: --port must be in 0-65535, got {args.port}")
    if args.image_size is not None and args.image_size <= 0:
        raise SetupError(
            f"Error: --image_size must be positive, got {args.image_size}")
    if bool(args.model_path) == bool(args.artifact):
        raise SetupError("Error: pass exactly one of -p/--model_path or "
                         "--artifact.")
    if args.quantize is not None:
        if not args.model_path:
            raise SetupError(
                "Error: --quantize int8 requires a checkpoint (-p); to serve "
                "an int8 AOT artifact, export it with tools/export_model "
                "--quantize int8 (the tier is part of the artifact).")
        if args.parity:
            raise SetupError("Error: --quantize int8 and --parity are mutually "
                             "exclusive (int8 is far outside the parity "
                             "budget).")
        if args.model_options == "double":
            raise SetupError("Error: --quantize int8 is gated to the "
                             "single-branch family, as in the JAX package. "
                             "Serve the default bf16 tier instead.")
        if not (args.calibration_mixed_dir and args.calibration_source_dir):
            raise SetupError(
                "Error: --quantize int8 requires --calibration_mixed_dir and "
                "--calibration_source_dir (tiles from the serving "
                "distribution to calibrate activation ranges on).")
        if args.calibration_tiles <= 0:
            raise SetupError(f"Error: --calibration_tiles must be positive, "
                             f"got {args.calibration_tiles}")
    elif args.calibration_mixed_dir or args.calibration_source_dir:
        raise SetupError("Error: --calibration_* dirs only apply with "
                         "--quantize int8.")
    if args.batch_buckets and not args.model_path:
        raise SetupError("Error: --batch_buckets requires a checkpoint (-p); "
                         "an artifact is served at one batch shape.")
    if args.num_devices not in (None, 1):
        raise SetupError(f"Error: --num_devices {args.num_devices}: this "
                         "package serves on one device only so far.")
    if args.artifact:
        if args.transport_dtype != "float32":
            raise SetupError("Error: --transport_dtype float16 requires a "
                             "checkpoint (-p); AOT artifacts are exported "
                             "for float32 input.")
        if args.allow_reload:
            raise SetupError("Error: --allow_reload requires a checkpoint (-p); "
                             "AOT artifacts carry their weights in the file.")


def _load_calibration_batch(args, image_size: int):
    """Pair, decode and normalize up to --calibration_tiles pairs for int8
    activation-range calibration -> (n, px, px, 2) f32 normalized array."""
    from crosstalk_tpu_torch.eval.int8_forward import load_calibration_tiles

    try:
        return load_calibration_tiles(
            args.calibration_mixed_dir, args.calibration_source_dir,
            image_size, max_tiles=args.calibration_tiles)
    except (ValueError, FileNotFoundError, OSError) as e:
        raise SetupError(f"Error loading calibration tiles: {e}")


def _artifact_predictor(args):
    """-> (predict, batch_size, image_size, model_info) for ``--artifact``;
    the program runs once at the serving shape before this returns."""
    import numpy as np

    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.io.export import load_exported

    device = resolve_device(args.device)  # raises when CUDA is missing
    print("--- Loading AOT artifact ---")
    try:
        fn, meta = load_exported(args.artifact, device=args.device)
    except (FileNotFoundError, ValueError) as e:
        raise SetupError(f"Error loading artifact {args.artifact}: {e}")
    meta_bs = meta.get("batch_size", "dynamic")
    # dynamic-batch artifacts serve at --batch_size; a pinned one dictates
    batch_size = args.batch_size if meta_bs == "dynamic" else int(meta_bs)
    meta_px = meta.get("image_size")
    if (meta_px is not None and args.image_size is not None
            and int(meta_px) != args.image_size):
        raise SetupError(f"Error: --image_size {args.image_size} does not match "
                         f"the artifact (exported for {int(meta_px)}px tiles).")
    image_size = int(meta_px or args.image_size or 256)
    shape = (batch_size, image_size, image_size, 2)

    def predict(raw: np.ndarray) -> np.ndarray:
        if raw.shape != shape:
            raise ValueError(f"predict expects shape {shape}, got {raw.shape}")
        return fn(raw)

    predict(np.zeros(shape, np.float32))  # before the first request arrives
    name = device_label(device)
    print(f"Using device: {name} x1")
    print(f"Serving artifact (batch {batch_size}, {image_size}px, "
          f"{meta.get('path', '?')} path)")
    info = {"artifact": args.artifact, **meta, "batch_size": batch_size,
            "devices": 1, "device": name}
    return predict, batch_size, image_size, info


def _checkpoint_predictor(args, buckets):
    """-> (predict, batch_size, image_size, model_info, reload_fn or None)
    for a ``.pth``."""
    import numpy as np

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.io.torch_convert import (
        compatible_px_range,
        image_size_compatible,
        infer_image_size,
        infer_model_size,
        load_pth,
        model_config_for_checkpoint,
    )
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    device = resolve_device(args.device)  # raises when CUDA is missing
    variant = args.model_options

    print("--- Loading model weights ---")
    try:
        state_dict = load_pth(args.model_path)
        size = infer_model_size(state_dict, variant)
    except (FileNotFoundError, KeyError, ValueError) as e:
        raise SetupError(f"Error loading model from {args.model_path}: {e}")
    if args.num_conv_blocks is not None and variant == "double":
        raise SetupError("Error: --num_conv_blocks applies to the "
                         "single-branch model only.")
    compute_dtype = "f32" if args.parity else "bf16"
    try:
        model_cfg = model_config_for_checkpoint(
            variant, state_dict,
            initial_filters=args.initial_filters,
            num_conv_blocks=args.num_conv_blocks,
            compute_dtype=compute_dtype,
        )
        detected_px = infer_image_size(state_dict, variant)
    except (KeyError, ValueError) as e:
        raise SetupError(f"Error: {e}")
    if model_cfg != ModelConfig(variant=variant, compute_dtype=compute_dtype):
        print(f"Detected non-default model size from the checkpoint: "
              f"{model_cfg}")
    if args.image_size is None:
        image_size = detected_px
        if detected_px != 256:
            print(f"Detected tile size from the checkpoint: {detected_px}px")
    elif not image_size_compatible(state_dict, variant, args.image_size):
        lo, hi = compatible_px_range(state_dict, variant)
        raise SetupError(
            f"Error: --image_size {args.image_size} does not match the "
            f"checkpoint's head (compatible tile sizes: {lo}-{hi}px).")
    else:
        image_size = args.image_size

    name = device_label(device)
    print(f"Using device: {name} x1")
    calib_batch = None

    def calibrate(sd):
        # one calibration site for startup AND /reload: activation ranges
        # depend on the weights upstream of each quantize point
        from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8

        return calibrate_int8(model_cfg, {k: v.to(device) for k, v in sd.items()},
                              calib_batch)

    scales = None
    if args.quantize == "int8":
        calib_batch = _load_calibration_batch(args, image_size)
        print(f"Calibrating int8 activation ranges on {calib_batch.shape[0]} "
              "tile pairs...")
        scales = calibrate(state_dict)

    batch_size = args.batch_size
    serve_sizes = (buckets or []) + [batch_size]
    path = ("f32-parity" if args.parity else "int8-serving" if args.quantize
            else "bf16-serving")
    shapes = f"batch {batch_size}" + (f" + buckets {buckets}" if buckets else "")
    print(f"Warming up the serving path ({shapes}, {path.replace('-', ' ')} path)...")

    def predictor(sd, int8_scales):
        return make_predictor(
            sd, model_cfg, serve_sizes, image_size=image_size,
            fast=not args.parity, input_dtype=np.dtype(args.transport_dtype),
            device=args.device, int8_scales=int8_scales,
        )

    predict = predictor(state_dict, scales)
    model_info = {
        "model": variant,
        **size,
        "checkpoint": args.model_path,
        "image_size": image_size,
        "path": path,
        "batch_size": batch_size,
        "devices": 1,
        "device": name,
        "transport_dtype": args.transport_dtype,
    }
    if buckets:
        model_info["batch_buckets"] = buckets
    if scales is not None:
        model_info["int8_scales"] = scales

    reload_fn = None
    if args.allow_reload:
        # POST /reload: load and warm the new checkpoint with the SAME
        # serving configuration (recalibrated for the int8 tier), then the
        # server swaps it in atomically
        def reload_fn(path):
            new_sd = load_pth(path)
            new_size = infer_model_size(new_sd, variant)
            if new_size != size:
                raise ValueError(
                    f"checkpoint size mismatch: serving {size}, reload "
                    f"candidate is {new_size} — restart the server to "
                    "change model size")
            if not image_size_compatible(new_sd, variant, image_size):
                new_px = infer_image_size(new_sd, variant)
                raise ValueError(
                    f"tile-size mismatch: serving {image_size}px, reload "
                    f"candidate was trained at {new_px}px — restart the "
                    "server to change tile size")
            new_scales = calibrate(new_sd) if calib_batch is not None else None
            info = {**model_info, "checkpoint": path}
            if new_scales is not None:
                info["int8_scales"] = new_scales
            return predictor(new_sd, new_scales), info

    return predict, batch_size, image_size, model_info, reload_fn


def build_server(args):
    """Parsed flags -> (CrosstalkServer, model_info), not yet serving.

    Loads the checkpoint (calibrating the int8 tier when asked) or the
    artifact, builds the predictor (which warms every batch shape on this
    thread, building the input-block kernel on the card) and binds the
    port. Raises SetupError with the message to print; a missing card
    raises RuntimeError from ``resolve_device``."""
    _check_flags(args)
    from crosstalk_tpu_torch.serve.server import CrosstalkServer

    buckets = None
    reload_fn = None
    if args.artifact:
        predict, batch_size, image_size, model_info = _artifact_predictor(args)
    else:
        if args.batch_buckets:
            from crosstalk_tpu_torch.serve.batcher import parse_batch_buckets

            try:
                buckets = parse_batch_buckets(args.batch_buckets, args.batch_size)
            except ValueError as e:
                raise SetupError(f"Error: {e}")
        predict, batch_size, image_size, model_info, reload_fn = (
            _checkpoint_predictor(args, buckets))

    server = CrosstalkServer(
        predict,
        batch_size=batch_size,
        image_size=image_size,
        host=args.host,
        port=args.port,
        max_delay_ms=args.max_delay_ms,
        model_info=model_info,
        request_timeout=args.request_timeout,
        verbose=args.verbose,
        max_body_bytes=args.max_body_mb << 20,
        max_tiles=args.max_tiles,
        transport_dtype=args.transport_dtype,
        reload_fn=reload_fn,
        bucket_sizes=buckets,
        io_timeout=args.io_timeout,
    )
    return server, model_info


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        server, _ = build_server(args)
    except SetupError as e:
        print(e)
        return 1
    host, port = server.address
    endpoints = "POST /predict, GET /healthz, GET /stats, GET /metrics" + (
        ", POST /reload" if args.allow_reload else "")
    print(f"Serving on http://{host}:{port}  ({endpoints}) — Ctrl-C to stop",
          flush=True)

    # SIGTERM (the orchestrator-standard stop signal) drains like Ctrl-C:
    # stop accepting, flush queued batches, resolve in-flight futures. The
    # handler disarms itself so a second SIGTERM cannot abort the drain.
    import signal

    def _sigterm(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nShutting down...", flush=True)
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
