"""End-to-end pipeline scale test (port of tools/scale_bench.py: a large
dataset, the host pipeline feeding the card).

Measures, on a generated N-pair dataset:
  1. the cold packed-cache build rate: the native C++ decoder writing a
     memory-mapped ``.npy`` (``TileStore(cache_dir=...)``), with the pairs
     each decoder served;
  2. the steady-state epoch rate of the port's real train path:
     ``iterate_batches`` -> ``device_batches`` (pinned host memory,
     asynchronous copies) -> ``train/steps.py``'s bf16 step, i.e. the host
     pipeline, the host-to-device copies and the compute together, with a
     probe of the host-to-device link beside it;
  or, with ``--feed_only``, the host side alone: the batches
  ``iterate_batches`` produces per second from the memory-mapped cache.

    python -m crosstalk_tpu_torch.tools.scale_bench [-n 2000] [-b 128]
        [--epochs 2] [--feed_only] [--device cuda|cpu]

The last line is one JSON object with every rate, the device, the host's
``os.cpu_count()`` and the decode threads.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

DECODE_THREADS = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--num_pairs", type=int, default=2000)
    parser.add_argument("-b", "--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--size", type=int, default=256,
                        help="Tile size of the generated dataset")
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Single-branch width override (default 128)")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override (default 6)")
    parser.add_argument("--keep", action="store_true")
    parser.add_argument("--data_dir", default=None,
                        help="Reuse an existing generated dataset directory "
                             "(skips generation; implies --keep)")
    parser.add_argument("--feed_only", action="store_true",
                        help="Measure the HOST pipeline's batch-production "
                             "rate (memmap reads + batch assembly, no "
                             "device)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Train on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)

    import torch

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import (
        TileStore,
        device_batches,
        iterate_batches,
        load_tiles,
    )
    from crosstalk_tpu_torch.device import device_label, resolve_device
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.tools.make_dataset import main as make_dataset
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    device = resolve_device(args.device)  # raises when CUDA is missing
    summary = {"device": device_label(device), "cpu_count": os.cpu_count(),
               "decode_threads": DECODE_THREADS}
    if args.data_dir:
        root = args.data_dir
        args.keep = True
        os.makedirs(root, exist_ok=True)
    else:
        root = tempfile.mkdtemp(prefix="crosstalk_scale_")
    try:
        if not os.path.isdir(os.path.join(root, "Mixed")):
            print(f"Generating {args.num_pairs} pairs under {root} ...")
            t0 = time.perf_counter()
            make_dataset([root, "-n", str(args.num_pairs), "--size", str(args.size)])
            print(f"  generated in {time.perf_counter() - t0:.1f}s")

        index = PairIndex(os.path.join(root, "Mixed"), os.path.join(root, "Source"))
        cache_path = os.path.join(root, "cache")
        cold = not os.path.isdir(cache_path) or not os.listdir(cache_path)
        before = dict(load_tiles.decoded)
        t0 = time.perf_counter()
        store = TileStore(index.samples, jobs=DECODE_THREADS, cache_dir=cache_path)
        dt = time.perf_counter() - t0
        decoded = {k: load_tiles.decoded[k] - before[k] for k in before}
        print(f"{'cold' if cold else 'warm'} cache build: {len(store)} pairs "
              f"in {dt:.2f}s ({len(store) / dt:,.0f} pairs/s, "
              f"{2 * len(store) / dt:,.0f} tiles/s; cache "
              f"{store.tiles.nbytes / 1e9:.2f} GB; pairs decoded natively "
              f"{decoded['native']}, in Python {decoded['python']}; "
              f"{os.cpu_count()} CPUs, {DECODE_THREADS} decode threads)")
        summary["cache_build"] = {
            "cold": cold, "pairs": len(store), "seconds": dt,
            "pairs_per_s": len(store) / dt, "decoded": decoded,
            "cache_bytes": int(store.tiles.nbytes)}

        if args.feed_only:
            # host-pipeline production rate: the full iterate_batches path
            # (memmapped reads, shuffle gather, pad/mask assembly) consumed
            # as fast as the host can produce it
            sink = 0.0
            summary["feed_epochs"] = []
            for epoch in range(args.epochs):
                t0 = time.perf_counter()
                n = 0
                for batch in iterate_batches(store, args.batch_size,
                                             shuffle=True, drop_last=True,
                                             seed=1, epoch=epoch):
                    sink += float(batch.inputs[0, 0, 0, 0]) + float(batch.labels[0, 0])
                    n += args.batch_size
                dt = time.perf_counter() - t0
                print(f"feed epoch {epoch}: {n} tiles in {dt:.2f}s -> "
                      f"{n / dt:,.0f} tiles/s host-pipeline production")
                summary["feed_epochs"].append({"tiles": n, "seconds": dt,
                                               "tiles_per_s": n / dt})
            print(f"(sink {sink:.3f})")
            print(json.dumps(summary))
            return 0

        # the host -> device link alone: one batch from pinned memory
        probe = torch.from_numpy(np.random.default_rng(9).random(
            (args.batch_size, *store.tiles.shape[1:])).astype(np.float32))
        pin = device.type == "cuda"
        if pin:
            probe = probe.pin_memory()
        best = float("inf")
        for _ in range(3):
            if pin:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            a = probe.to(device, non_blocking=pin)
            float(a.view(-1)[0])  # waits for the copy
            best = min(best, time.perf_counter() - t0)
        nbytes = probe.numel() * 4
        print(f"H2D link: {nbytes / best / 1e6:,.0f} MB/s ({nbytes / 1e6:.0f} MB/batch "
              f"-> ~{args.batch_size / best:,.0f} tiles/s transfer ceiling)")
        summary["h2d_mb_per_s"] = nbytes / best / 1e6

        model_kw = {k: v for k, v in (("initial_filters", args.initial_filters),
                                      ("num_conv_blocks", args.num_conv_blocks))
                    if v is not None}
        cfg = ModelConfig(variant="single", compute_dtype="bf16", **model_kw)
        model = init_model(build_model(cfg, image_size=int(store.tiles.shape[1])),
                           torch.Generator().manual_seed(0)).to(device)
        state = init_train_state(model, OptimConfig())
        step = make_train_step(state, compute_dtype="bf16", seed=2)

        summary["epochs"] = []
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            n_steps = 0
            last_loss = None
            for batch in device_batches(
                iterate_batches(store, args.batch_size, shuffle=True,
                                drop_last=True, seed=1, epoch=epoch), device):
                last_loss = step(batch.inputs, batch.labels, 1e-4)
                n_steps += 1
            loss = float(last_loss)  # device fence
            dt = time.perf_counter() - t0
            tiles = n_steps * args.batch_size
            print(f"epoch {epoch}: {tiles} tiles in {dt:.2f}s -> "
                  f"{tiles / dt:,.0f} tiles/s end-to-end (loss {loss:.4f})")
            summary["epochs"].append({"tiles": tiles, "seconds": dt,
                                      "tiles_per_s": tiles / dt, "loss": loss})
        print(json.dumps(summary))
        return 0
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
