"""Remote evaluation CLI (port of crosstalk_tpu/cli/remote_eval.py): score
a labeled paired-tile directory against a RUNNING crosstalk server instead
of loading a checkpoint locally.

The client needs only this package's data and IO code: no weights and no
card. Decode happens locally, inference wherever the server runs, and the
output is the ``eval_run_{ts}/`` contract (params.txt, a 3-column
predictions CSV, and the actual-vs-predicted scatter where matplotlib is
installed).

    # on the GPU host
    python -m crosstalk_tpu_torch.cli.serve -p model.pth --transport_dtype float16
    # on any client
    python -m crosstalk_tpu_torch.cli.remote_eval -m MIXED -s SOURCE \\
        --url http://gpu-host:8000

The default float16 payload halves the upload.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate a paired-tile directory against a running "
                    "crosstalk inference server."
    )
    parser.add_argument("-m", "--mixed_channel_data_dir", type=str,
                        required=True, help="Directory for mixed channel data")
    parser.add_argument("-s", "--pure_source_data_dir", type=str,
                        required=True, help="Directory for pure source data")
    parser.add_argument("--url", type=str, required=True,
                        help="Server base URL, e.g. http://host:8000")
    parser.add_argument("-j", "--cpu_jobs", type=int, default=4,
                        help="Local TIFF-decode threads")
    parser.add_argument("-o", "--output_base", type=str, default=".",
                        help="Where to create the eval_run_{ts} directory")
    parser.add_argument("--request_tiles", type=int, default=64,
                        help="Tiles per HTTP request (larger amortizes the "
                             "per-request overhead; must be within the "
                             "server's --max_tiles)")
    parser.add_argument("--dtype", type=str, default="float16",
                        choices=["float16", "float32"],
                        help="Payload dtype; float16 halves the upload with "
                             "~1e-3 alpha perturbation")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="Per-request timeout, seconds")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.io import artifacts
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    if args.request_tiles <= 0:
        print(f"Error: --request_tiles must be positive, "
              f"got {args.request_tiles}")
        return 1

    client = CrosstalkClient(args.url, timeout=args.timeout)
    try:
        health = client.health()
    except Exception as e:
        print(f"Error: server at {args.url} is not reachable: {e}")
        return 1
    print(f"Server: {health}")

    print("\nCreating dataset instances for initial file listing...")
    try:
        index = PairIndex(args.mixed_channel_data_dir,
                          args.pure_source_data_dir)
    except (ValueError, FileNotFoundError) as e:
        print(f"Error initializing dataset: {e}")
        return 1
    print(f"Found {len(index)} matching samples.")

    ts = artifacts.timestamp()
    run_dir = artifacts.make_eval_run_dir(args.output_base, ts)
    artifacts.write_params_txt(run_dir, vars(args))
    print(f"Parameters saved to {run_dir}/params.txt")

    store = TileStore(index.samples, jobs=args.cpu_jobs)
    rows = []
    sq_sum = 0.0
    n = len(store)
    for start in range(0, n, args.request_tiles):
        stop = min(start + args.request_tiles, n)
        tiles = np.asarray(store.tiles[start:stop], np.float32)
        try:
            preds = client.predict(tiles, dtype=args.dtype)
        except Exception as e:
            print(f"Error: prediction request failed at rows "
                  f"{start}:{stop}: {e}")
            return 1
        for j in range(stop - start):
            actual = float(store.labels[start + j, 0])
            pred = float(preds[j])
            sq_sum += (actual - pred) ** 2
            rows.append({
                "Image_ID": int(store.ids[start + j]),
                "Actual_Label": np.float32(actual),
                "Predicted_Label": np.float32(pred),
            })
        print(f"  {stop}/{n} tiles scored", end="\r", flush=True)
    print()

    loss = sq_sum / max(n, 1)
    print(f"Final Test Loss: {loss:.6f}")

    csv_path = os.path.join(run_dir, f"test_predictions_{ts}.csv")
    artifacts.write_predictions_csv(
        csv_path, rows, ["Image_ID", "Actual_Label", "Predicted_Label"]
    )
    print(f"Predictions saved to {csv_path}")
    plot = artifacts.plot_predictions_scatter(
        run_dir, rows, "test", f"test_predictions_plot_{ts}.png"
    )
    if plot is not None:
        print(f"Plot saved to {plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
