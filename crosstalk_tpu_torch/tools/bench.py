"""Throughput benchmark of the port: 256x256 tiles per second per card on
both model families (port of the root ``bench.py``).

    python -m crosstalk_tpu_torch.tools.bench [--num_devices N] [--skip_double]
        [--skip_int8] [--infer_batch 512] [--train_batch 128] [--scan_len L]
        [--image_size 256] [--device cuda|cpu]

Prints ONE JSON line with the keys of the root ``bench.py``:
``metric``, ``value``, ``unit``, ``vs_baseline``, ``infer_tps`` (the
single-branch ``--fast`` forward, ``eval/fast_forward.py``), ``train_tps``
(the production train step, ``train/steps.py``), ``two_branch_infer_tps``,
``two_branch_train_tps``, ``int8_infer_tps`` (``eval/int8_forward.py``,
single-branch), the batch each rate ran at and ``device``; plus
``power_limit``, the card's ``power.limit`` as nvidia-smi reads it (null
on the CPU), since a card set below its maximum runs slower under load.
``vs_baseline`` is ``value`` / 5,000: the rebuild's throughput target of
tiles/s per chip set in BASELINE.md, not a speed measured on any chip. A
measure skipped (``--skip_double``; the int8 tier under ``--skip_int8`` or
``--num_devices`` > 1) is ``null``, never 0.0.

A timed unit is a Python loop of steps over a batch resident on the card,
fenced by ``torch.cuda.synchronize()`` and timed on the host clock:
  * inference: ``INFER_SCAN_LEN`` steps of ``normalize_batch_nhwc(x + i *
    1e-9)``, the forward, and the sum of its predictions, accumulated (the
    per-step perturbation keeps the work equal to the JAX program's, whose
    compiler would otherwise hoist the loop-invariant forward); one warm-up
    unit, then the best of three;
  * training: ``TRAIN_SCAN_LEN`` calls of the train step (bf16, on-device
    flips, dropout, Adam with L2) at lr 1e-4; one warm unit, then one timed
    unit, with one step function for both (it wraps the model in DDP once).
On ``torch.cuda.OutOfMemoryError`` a measure frees the cache and retries
at half the batch, down to 16 rows for inference and 8 for training; the
JSON reports the batch that ran.

``--num_devices N`` measures data parallelism: inference on a replica set
(``parallel/mesh.data_mesh``, one forward and ``infer_batch`` resident rows
per device), training as N ranks (``parallel/distributed.launch_local``:
the DDP step with cross-replica BatchNorm, ``train_batch`` rows per rank;
rank 0 times the unit after a barrier). The ``*_global`` keys add up the
devices; ``value`` and the other rates stay per device. On the CPU (a
replica set of ``[cpu] * N`` and Gloo ranks) the rates are not meaningful
and the JSON says so.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward
from crosstalk_tpu_torch.models.registry import build_model, init_model
from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

INFER_SCAN_LEN = 32
TRAIN_SCAN_LEN = 16
INFER_FLOOR = 16       # the smallest batch an out-of-memory retry goes down to
TRAIN_FLOOR = 8
TRAIN_LR = 1e-4
BASELINE_TPS = 5000.0  # BASELINE.md's rebuild target, tiles/s per chip
CALIBRATION_TILES = 256


def _sync(devices: Sequence[torch.device]) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _free(devices: Sequence[torch.device]) -> None:
    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def _timed(unit: Callable[[], object], devices: Sequence[torch.device],
           repeats: int = 3) -> float:
    """One warm-up call of ``unit``, then the best host-clock seconds of
    ``repeats`` calls, each fenced by a synchronize of every device."""
    unit()
    _sync(devices)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        unit()
        _sync(devices)
        best = min(best, time.perf_counter() - t0)
    return best


def with_halving(measure: Callable[[int], float], batch: int, floor: int,
                 devices: Sequence[torch.device]):
    """-> (measure(batch), batch), retrying at half the batch after a CUDA
    out-of-memory error; at or below ``floor`` the error propagates."""
    while True:
        try:
            return measure(batch), batch
        except torch.cuda.OutOfMemoryError:
            if batch <= floor:
                raise
        # outside the handler, so that the failed attempt's frames are gone
        _free(devices)
        print(f"out of memory at batch {batch}; retrying at {batch // 2}",
              file=sys.stderr, flush=True)
        batch //= 2


def init_weights(cfg: ModelConfig, image_size: int, process_group=None) -> torch.nn.Module:
    """The full-width model of ``cfg`` on the CPU, drawn from seed 0."""
    model = build_model(cfg, image_size=image_size, process_group=process_group)
    return init_model(model, torch.Generator().manual_seed(0))


def _tiles(seed: int, rows: int, image_size: int) -> np.ndarray:
    # float64 draws cast to float32, as the root bench.py draws them
    rng = np.random.default_rng(seed)
    return rng.random((rows, image_size, image_size, 2)).astype(np.float32)


def infer_unit(forwards: Sequence[Callable], xs: Sequence[torch.Tensor],
               steps: int) -> List[torch.Tensor]:
    """The timed inference unit: ``steps`` steps, each running every
    replica's ``forward(normalize_batch_nhwc(x + i * 1e-9))`` on its own
    resident batch. -> per replica, the float32 sum of its predictions over
    the steps (0-d, on its device)."""
    accs = [torch.zeros((), device=x.device) for x in xs]
    # i * 1e-9 in float32, as the JAX loop computes it
    shifts = [torch.arange(steps, dtype=torch.float32, device=x.device) * 1e-9 for x in xs]
    for i in range(steps):
        for r, (forward, x) in enumerate(zip(forwards, xs)):
            preds = forward(normalize_batch_nhwc(x + shifts[r][i]))
            accs[r] = accs[r] + preds.sum()
    return accs


def infer_seconds(variant: str, batch: int, steps: int, image_size: int,
                  devices: Sequence[torch.device]) -> float:
    """Best seconds of one inference unit of the ``--fast`` forward with
    ``batch`` resident rows per device."""
    cfg = ModelConfig(variant=variant, compute_dtype="bf16")
    sd = init_weights(cfg, image_size).state_dict()
    forwards = [make_fast_forward(cfg, {k: v.to(d) for k, v in sd.items()}) for d in devices]
    tiles = _tiles(0, len(devices) * batch, image_size)
    xs = [torch.from_numpy(tiles[r * batch:(r + 1) * batch]).to(d)
          for r, d in enumerate(devices)]
    del tiles
    with torch.inference_mode():
        return _timed(lambda: infer_unit(forwards, xs, steps), devices)


def int8_seconds(batch: int, steps: int, image_size: int, device: torch.device) -> float:
    """Best seconds of one inference unit of the single-branch int8 tier,
    calibrated on the first ``min(256, batch)`` normalized tiles."""
    cfg = ModelConfig(variant="single", compute_dtype="bf16")
    sd = {k: v.to(device) for k, v in init_weights(cfg, image_size).state_dict().items()}
    x = torch.from_numpy(_tiles(3, batch, image_size)).to(device)
    with torch.inference_mode():
        scales = calibrate_int8(cfg, sd, normalize_batch_nhwc(x[:min(CALIBRATION_TILES, batch)]))
        quant = make_int8_forward(cfg, sd, scales)
        return _timed(lambda: infer_unit([quant], [x], steps), [device])


def train_unit(step: Callable, x: torch.Tensor, y: torch.Tensor, steps: int) -> torch.Tensor:
    """The timed training unit: ``steps`` optimizer steps at lr 1e-4 on one
    resident batch. -> the last step's loss (a 0-d device tensor)."""
    for _ in range(steps):
        loss = step(x, y, TRAIN_LR)
    return loss


def train_seconds(variant: str, batch: int, steps: int, image_size: int,
                  device: torch.device, process_group=None) -> float:
    """Seconds of one training unit after one warm unit, with ``batch`` rows
    on this device (this rank's rows of the ranks' global batch). The model,
    optimizer state and step function are built here, so that a retry after
    running out of memory starts from nothing."""
    import torch.distributed as dist

    world, rank = 1, 0
    if process_group is not None:
        world, rank = dist.get_world_size(process_group), dist.get_rank(process_group)
    cfg = ModelConfig(variant=variant, compute_dtype="bf16")
    model = init_weights(cfg, image_size, process_group).to(device)
    state = init_train_state(model, OptimConfig())
    step = make_train_step(state, compute_dtype=cfg.compute_dtype, augment=True,
                           process_group=process_group)
    rng = np.random.default_rng(1)  # the global batch, x then y, as the root bench.py draws it
    x = rng.random((world * batch, image_size, image_size, 2)).astype(np.float32)
    y = rng.uniform(0, 0.5, (world * batch, 1)).astype(np.float32)
    mine = slice(rank * batch, (rank + 1) * batch)
    x, y = torch.from_numpy(x[mine]).to(device), torch.from_numpy(y[mine]).to(device)

    def fence():
        _sync([device])
        if process_group is not None:
            dist.barrier(group=process_group)

    train_unit(step, x, y, steps)  # warm
    fence()
    t0 = time.perf_counter()
    train_unit(step, x, y, steps)
    fence()
    return time.perf_counter() - t0


def _train_rank(variant: str, batch: int, steps: int, image_size: int, device_type: str,
                out: str) -> None:
    """One training rank of ``--num_devices`` (started by ``launch_local``);
    rank 0 writes the unit's seconds and the batch that ran to ``out``."""
    import torch.distributed as dist

    from crosstalk_tpu_torch.device import set_parity_numerics
    from crosstalk_tpu_torch.parallel.distributed import initialize, rank, rank_device

    group = initialize(device_type=device_type)
    try:
        device = rank_device(device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # the host's cores, shared by its ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
        set_parity_numerics()
        seconds, batch = with_halving(
            lambda b: train_seconds(variant, b, steps, image_size, device, group),
            batch, TRAIN_FLOOR, [device])
        if rank() == 0:
            with open(out, "w") as f:
                json.dump({"seconds": seconds, "batch": batch}, f)
    finally:
        dist.destroy_process_group()


def bench_model(variant: str, infer_batch: int, train_batch: int,
                devices: Sequence[torch.device], scan_len: Optional[int] = None,
                image_size: int = 256):
    """-> (infer_tps, train_tps, infer_batch, train_batch) for one model.

    The batches are per device and the rates add up every device of
    ``devices``; more than one device trains as that many ranks."""
    n_dev = len(devices)
    train_steps = TRAIN_SCAN_LEN if scan_len is None else scan_len
    infer_steps = INFER_SCAN_LEN if scan_len is None else scan_len

    dt, infer_batch = with_halving(
        lambda b: infer_seconds(variant, b, infer_steps, image_size, devices),
        infer_batch, INFER_FLOOR, devices)
    infer_tps = infer_steps * n_dev * infer_batch / dt
    _free(devices)

    if n_dev == 1:
        dt, train_batch = with_halving(
            lambda b: train_seconds(variant, b, train_steps, image_size, devices[0]),
            train_batch, TRAIN_FLOOR, devices)
    else:
        from crosstalk_tpu_torch.parallel.distributed import launch_local

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            rc = launch_local(_train_rank, n_dev, variant, train_batch, train_steps,
                              image_size, devices[0].type, out)
            if rc != 0:
                raise RuntimeError(f"a training rank of the {variant} model failed")
            with open(out) as f:
                report = json.load(f)
        dt, train_batch = report["seconds"], report["batch"]
    train_tps = train_steps * n_dev * train_batch / dt
    _free(devices)
    return infer_tps, train_tps, infer_batch, train_batch


def bench_int8_single(infer_batch: int, device: torch.device,
                      scan_len: Optional[int] = None, image_size: int = 256):
    """The int8 serving tier on the single-branch model, one device.
    -> (tiles/s, batch)."""
    steps = INFER_SCAN_LEN if scan_len is None else scan_len
    dt, infer_batch = with_halving(
        lambda b: int8_seconds(b, steps, image_size, device), infer_batch, INFER_FLOOR,
        [device])
    _free([device])
    return steps * infer_batch / dt, infer_batch


def power_limit(device: torch.device) -> Optional[str]:
    """The card's ``power.limit`` as nvidia-smi reads it; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.splitlines()[0].rsplit(",", 1)[1].strip()


def main(argv=None) -> int:
    from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics
    from crosstalk_tpu_torch.parallel.mesh import data_mesh, visible_devices

    parser = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.bench",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--num_devices", type=int, default=1,
        help="measure data parallelism over N devices (per-device batches; "
             "the *_global rates add up every device). Default 1")
    parser.add_argument("--skip_double", action="store_true",
                        help="single-branch model only")
    parser.add_argument("--skip_int8", action="store_true",
                        help="skip the int8-tier measurement (one device only)")
    parser.add_argument("--infer_batch", type=int, default=512,
                        help="per-device inference batch (default 512)")
    parser.add_argument("--train_batch", type=int, default=128,
                        help="per-device train batch (default 128)")
    parser.add_argument("--scan_len", type=int, default=None,
                        help="steps of both timed units (default 16 train / 32 "
                             "infer); lower it for CPU smokes")
    parser.add_argument("--image_size", type=int, default=256,
                        help="tile size (default 256; lower it for CPU smokes)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="measure on the CUDA cards (default) or the CPU")
    args = parser.parse_args(argv)
    for flag in ("num_devices", "infer_batch", "train_batch", "image_size"):
        if getattr(args, flag) < 1:
            parser.error(f"--{flag} must be >= 1")
    if args.scan_len is not None and args.scan_len < 1:
        parser.error("--scan_len must be >= 1")

    device = resolve_device(args.device)
    n_dev = args.num_devices
    available = visible_devices(device.type)
    if n_dev > available:
        parser.error(f"--num_devices {n_dev}: only {available} {device.type} "
                     f"device(s) visible")
    devices = data_mesh(n_dev, device.type)
    set_parity_numerics()
    limit = power_limit(device)

    infer_tps, train_tps, infer_batch, train_batch = bench_model(
        "single", args.infer_batch, args.train_batch, devices, args.scan_len,
        args.image_size)
    if args.skip_double:
        tb_infer = tb_train = tb_ib = tb_tb = None
    else:
        # two-branch inference at 256 and training at 128 rows per device,
        # the root bench.py's batches
        tb_infer, tb_train, tb_ib, tb_tb = bench_model(
            "double", 256, 128, devices, args.scan_len, args.image_size)
    int8_tps = int8_batch = None
    if n_dev == 1 and not args.skip_int8:
        int8_tps, int8_batch = bench_int8_single(args.infer_batch, devices[0],
                                                 args.scan_len, args.image_size)

    value = round(infer_tps / n_dev, 1)
    result = {
        "metric": "256x256 tiles/sec/chip, single-branch bf16 inference "
                  "(train step rate in train_tps; two-branch model in "
                  "two_branch_*)",
        "value": value,
        "unit": "tiles/sec/chip",
        "vs_baseline": round(value / BASELINE_TPS, 3),
        "infer_tps": round(infer_tps / n_dev, 1),
        "train_tps": round(train_tps / n_dev, 1),
        "two_branch_infer_tps": None if tb_infer is None else round(tb_infer / n_dev, 1),
        "two_branch_train_tps": None if tb_train is None else round(tb_train / n_dev, 1),
        "int8_infer_tps": None if int8_tps is None else round(int8_tps, 1),
        "int8_infer_batch": int8_batch,
        "infer_batch": infer_batch,
        "train_batch": train_batch,
        "two_branch_infer_batch": tb_ib,
        "two_branch_train_batch": tb_tb,
        "device": torch.cuda.get_device_name(devices[0]) if device.type == "cuda" else "cpu",
        "power_limit": limit,
    }
    if n_dev > 1:
        result["num_devices"] = n_dev
        result["infer_tps_global"] = round(infer_tps, 1)
        result["train_tps_global"] = round(train_tps, 1)
        result["two_branch_infer_tps_global"] = (
            None if tb_infer is None else round(tb_infer, 1))
        result["two_branch_train_tps_global"] = (
            None if tb_train is None else round(tb_train, 1))
        if device.type == "cpu":
            result["note"] = ("CPU replica set and Gloo ranks: validates the "
                              "data-parallel programs only; rates are NOT meaningful")
            print("NOTE: running on the CPU: plumbing validation only, rates are "
                  "not meaningful.", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
