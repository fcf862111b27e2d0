"""Online serving, as the serve CLI runs it: the HTTP server
(``serve/server.py``) in this process, its dynamic batcher and the predictor
(``serve/predictor.py``: the folded-BN bf16 forward with block 0 in kernel
K1), under the open-loop load of ``drivers/serve_load.py`` from a second
process that never touches the card.

Parameters (``traffic/serve-open.json``): the server's ``batch_size``,
``max_delay_ms`` and ``transport_dtype``; the load's ``sizes``, ``probs``,
``templates``, ``senders`` and ``answer_within_s``; ``calibration_tiles``.

Only ``sweep_serve.py`` uses these pieces so far: no cell of
``BENCHMARK.json`` serves yet, since no bound on a tail latency held
(PERF.md, Open questions), so this driver has no ``run``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers.common import model_config
from benchmark.harness import ROOT, Run


def load_params(r: Run) -> dict:
    return {**r.params, "image_size": r.config["image_size"]}


def start_server(r: Run):
    """-> (the running server, the weights it serves)."""
    from crosstalk_tpu_torch.serve.predictor import make_predictor
    from crosstalk_tpu_torch.serve.server import CrosstalkServer

    p, cfg, dev = r.params, r.config, r.device
    calib, _ = inputs.make_tiles(r.seed, p["calibration_tiles"], cfg["image_size"], dev,
                                 what="calibration")
    weights = inputs.make_weights(cfg, r.seed, dev, calib, p["bn_shift"])
    mcfg = model_config(cfg)
    del calib
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    dtype = np.dtype(p["transport_dtype"])
    predict = make_predictor(weights, mcfg, [p["batch_size"]], image_size=cfg["image_size"],
                             fast=True, input_dtype=dtype, device=dev.type)
    server = CrosstalkServer(predict, p["batch_size"], image_size=cfg["image_size"],
                             port=0, max_delay_ms=p["max_delay_ms"],
                             transport_dtype=p["transport_dtype"])
    server.start_background()
    return server, weights


def start_load(r: Run, server, rate: float, seconds: float) -> subprocess.Popen:
    """Start the load process; returns once it is ready to send."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    load = subprocess.Popen(
        [sys.executable, "-m", "benchmark.drivers.serve_load",
         "--port", str(server.address[1]), "--seed", str(r.seed), "--rate", str(rate),
         "--seconds", str(seconds), "--params", json.dumps(load_params(r))],
        cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    line = load.stdout.readline()
    if line.strip() != "ready":
        load.kill()
        load.wait()
        raise RuntimeError(f"the load process did not start: {line!r}")
    return load


def offer(r: Run, server, load: subprocess.Popen, seconds: float) -> dict:
    """Run one window of the started load -> its results, with the batcher's
    counters over the window (``stats``) and the window's length."""
    with r.window():
        t0 = time.monotonic() + 0.05
        before = server.batcher.stats()
        load.stdin.write(f"go {t0!r}\n")
        load.stdin.flush()
        time.sleep(max(t0 + seconds - time.monotonic(), 0.0))
        after = server.batcher.stats()
        span = time.monotonic() - t0
    out = json.loads(load.stdout.readline())
    load.wait(timeout=60)
    out["stats"] = {k: after[k] - before[k] for k in
                    ("requests", "tiles", "batches", "padded_rows", "capacity_rows",
                     "device_seconds")}
    out["span_s"] = span
    return out


def p95_ms(latency) -> float:
    """The 95th percentile (nearest rank) in ms; an unanswered request is
    infinitely late."""
    lat = sorted(math.inf if v is None else v for v in latency)
    return 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
