"""Find the highest rate a serving cell sustains: one server, a window at
each offered rate in turn, each with a load process of its own.

    python3 benchmark/sweep_serve.py --config single --traffic serve-open \\
        --rates 200,400,600,800 --seconds 10 --seed 5

Prints, per rate, the offered and completed tiles/s (tiles of requests due
in the window and answered by its end, over the window), the 95th
percentile latency from the due time, the failed requests and how late the
generator ran. The knee is the highest offered rate whose completed rate
keeps up with it; a serving cell's rate is about four fifths of it,
written into ``workloads/<cell>.json``.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="single")
    ap.add_argument("--traffic", default="serve-open")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.drivers import serve

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = harness.Cell(f"{args.config}.{args.traffic}", 1, args.config,
                        harness.load_json(harness.BENCH_DIR / "configs" / f"{args.config}.json"),
                        args.traffic,
                        harness.load_json(harness.BENCH_DIR / "traffic" / f"{args.traffic}.json"),
                        [], [])
    run = harness.Run(cell, args.seed, args.seconds, False, torch.device("cuda", 0),
                      T_START)
    server, _ = serve.start_server(run)
    try:
        for rate in (float(x) for x in args.rates.split(",")):
            load = serve.start_load(run, server, rate, args.seconds)
            try:
                out = serve.offer(run, server, load, args.seconds)
            finally:
                if load.poll() is None:
                    load.kill()
                    load.wait()
            done = sum(s for s, d, v in zip(out["sizes"], out["due"], out["latency"])
                       if v is not None and d + v <= args.seconds)
            print(json.dumps({
                "offered_tiles_per_s": sum(out["sizes"]) / args.seconds,
                "completed_tiles_per_s": done / args.seconds,
                "p95_ms": serve.p95_ms(out["latency"]),
                "requests": len(out["latency"]),
                "failed": sum(v is None for v in out["latency"]),
                "generator_late_s": out["late_s"],
                "predictor_busy": out["stats"]["device_seconds"] / out["span_s"],
                "occupancy": 1 - out["stats"]["padded_rows"] / max(out["stats"]["capacity_rows"], 1),
            }), flush=True)
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
