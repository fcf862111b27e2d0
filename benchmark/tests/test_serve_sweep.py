"""The serving path that ``sweep_serve.py`` drives, on the CPU at a tiny
size: the in-process server under the open-loop load of its own process
answers every request of a short window."""

import math
import time

import torch

from benchmark import harness
from benchmark.drivers import serve
from benchmark.tests.conftest import TINY


def test_the_sweep_s_server_answers_every_request_of_a_window():
    params = {**harness.load_json(harness.BENCH_DIR / "traffic" / "serve-open.json"),
              "calibration_tiles": 16, "batch_size": 16, "senders": 4,
              "templates": {"1": 2, "4": 2, "16": 1, "64": 1}}
    config = {**harness.load_json(harness.BENCH_DIR / "configs" / "single.json"),
              **TINY["single"], "compute_dtype": "f32"}
    cell = harness.Cell("single.serve-open", 1, "single", config, "serve-open", params,
                        [], [])
    run = harness.Run(cell, 2**31 + 4321, 1.0, False, torch.device("cpu"),
                      time.monotonic())
    server, _ = serve.start_server(run)
    load = None
    try:
        load = serve.start_load(run, server, 30.0, run.seconds)
        out = serve.offer(run, server, load, run.seconds)
    finally:
        if load is not None and load.poll() is None:
            load.kill()
            load.wait()
        server.shutdown()
    assert out["latency"] and all(v is not None for v in out["latency"])
    assert math.isfinite(serve.p95_ms(out["latency"]))
    assert out["stats"]["requests"] >= len(out["latency"])
