"""Load-test the serving stack (port of tools/serve_bench.py): dynamic
batcher + HTTP front under concurrent clients, reporting throughput and
latency percentiles.

Measures the ONLINE serving path end to end (HTTP parse -> batcher queue ->
padded fixed-shape device batch -> JSON response): the port's
``serve/predictor.make_predictor`` (the ``--fast`` forward by default, K1
launched on every served batch on the card), ``serve/server`` and
``serve/client``.

    python -m crosstalk_tpu_torch.tools.serve_bench [--batch_size 256]
        [--clients 8] [--tiles_per_request 32] [--seconds 20] [--parity]
        [-o single] [-p model.pth] [--device cuda|cpu]

Uses a seeded freshly initialized model (serving throughput does not depend
on the weights); pass -p to serve a real checkpoint instead. Prints one JSON
line: tiles/s, requests, latency p50/p95/p99/max, batch occupancy, the
device's share of the wall and the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--model_options", default="single",
                    choices=["single", "double"])
    ap.add_argument("-p", "--model_path", default=None,
                    help=".pth to serve (default: fresh init)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--batch_buckets", type=str, default=None,
                    help="Comma-separated extra batch shapes below "
                         "batch_size (see cli.serve --batch_buckets): "
                         "light-traffic flushes ride the smallest bucket")
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--tiles_per_request", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--transport_dtype", default="float32",
                    choices=["float32", "float16"],
                    help="Device-batch dtype (float16 halves H2D bytes)")
    ap.add_argument("--client_dtype", default=None,
                    choices=["float32", "float16"],
                    help="Client payload dtype (float16 halves HTTP bytes);"
                         " default: the transport dtype")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Serve on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)

    import torch

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor
    from crosstalk_tpu_torch.serve.server import CrosstalkServer

    device = resolve_device(args.device)  # raises when CUDA is missing
    compute_dtype = "f32" if args.parity else "bf16"
    if args.model_path:
        from crosstalk_tpu_torch.io.torch_convert import (
            load_pth,
            model_config_for_checkpoint,
        )

        state_dict = load_pth(args.model_path)
        cfg = model_config_for_checkpoint(args.model_options, state_dict,
                                          compute_dtype=compute_dtype)
    else:
        from crosstalk_tpu_torch.models.registry import build_model, init_model

        cfg = ModelConfig(variant=args.model_options, compute_dtype=compute_dtype)
        model = init_model(build_model(cfg, image_size=args.image_size),
                           torch.Generator().manual_seed(0))
        state_dict = model.state_dict()

    buckets = None
    if args.batch_buckets:
        from crosstalk_tpu_torch.serve.batcher import parse_batch_buckets

        try:  # validate BEFORE make_predictor warms anything
            buckets = parse_batch_buckets(args.batch_buckets, args.batch_size)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    print(f"Warming (batch {args.batch_size}"
          + (f" + buckets {buckets}" if buckets else "")
          + f", {compute_dtype}, {args.transport_dtype} transport) on "
          f"{device_label(device)}...", file=sys.stderr)
    predict = make_predictor(state_dict, cfg,
                             (buckets or []) + [args.batch_size],
                             image_size=args.image_size,
                             fast=not args.parity,
                             input_dtype=np.dtype(args.transport_dtype),
                             device=args.device)
    server = CrosstalkServer(predict, batch_size=args.batch_size,
                             image_size=args.image_size, port=0,
                             max_delay_ms=args.max_delay_ms,
                             transport_dtype=args.transport_dtype,
                             bucket_sizes=buckets)
    server.start_background()
    host, port = server.address
    client_url = f"http://{host}:{port}"
    print(f"Serving on {client_url}; {args.clients} clients x "
          f"{args.tiles_per_request} tiles/request for {args.seconds}s",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    tiles = rng.random(
        (args.tiles_per_request, args.image_size, args.image_size, 2),
        np.float32,
    )
    latencies, counts = [], []
    stop = time.monotonic() + args.seconds
    lock = threading.Lock()

    client_dtype = args.client_dtype or args.transport_dtype

    failures = []

    def worker():
        c = CrosstalkClient(client_url)
        n, lats = 0, []
        try:
            while time.monotonic() < stop:
                t0 = time.monotonic()
                out = c.predict(tiles, dtype=client_dtype)
                lats.append(time.monotonic() - t0)
                n += out.shape[0]
        except Exception as e:  # noqa: BLE001 — a dead client must FAIL the
            with lock:          # bench, not silently deflate its numbers
                failures.append(f"{type(e).__name__}: {e}")
        with lock:
            counts.append(n)
            latencies.extend(lats)

    t_start = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start

    lat = np.sort(np.asarray(latencies))
    total = int(sum(counts))
    stats = server.batcher.stats()
    server.shutdown()
    if failures:
        print(json.dumps({"error": "client worker(s) failed mid-run — "
                                   "throughput numbers would be wrong",
                          "failures": failures[:8]}))
        return 1
    if len(lat) == 0:
        print(json.dumps({"error": "no requests completed in the window; "
                                   "raise --seconds or lower --batch_size"}))
        return 1
    print(json.dumps({
        "tiles_per_sec": round(total / wall, 1),
        "requests": len(lat),
        "latency_ms_p50": round(float(lat[len(lat) // 2] * 1e3), 2),
        "latency_ms_p95": round(float(lat[int(len(lat) * 0.95)] * 1e3), 2),
        "latency_ms_p99": round(float(lat[int(len(lat) * 0.99)] * 1e3), 2),
        "latency_ms_max": round(float(lat[-1] * 1e3), 2),
        "batch_occupancy": round(stats.get("mean_batch_occupancy", 0.0), 3),
        "device_busy_frac": round(stats["device_seconds"] / wall, 3),
        "batches": stats["batches"],
        "transport_dtype": args.transport_dtype,
        "client_dtype": client_dtype,
        "device": device_label(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
