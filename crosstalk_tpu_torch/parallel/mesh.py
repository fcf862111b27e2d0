"""Replica sets: one process driving several devices for inference (port of
crosstalk_tpu/parallel/mesh.py).

The workload's only profitable sharding axis is the batch: the models
(13M / 137M parameters) fit on every device, and the tiles are fixed 256x256
crops. Where the JAX package builds a 1-axis 'data' mesh and lets GSPMD
shard a batch over it inside one process, the eval, predict and serve CLIs
here hold one replica of the forward per device: ``data_mesh`` picks the
devices and ``replicated_forward`` splits each batch into one row block per
replica, runs each block on its device (the card's replicas each launch the
fused input-block kernel) and concatenates the results on the first device.
Training runs as ranks instead (parallel/distributed.py).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import torch


def visible_devices(device_type: str) -> int:
    """The devices of ``device_type`` this process can use: the visible CUDA
    cards, or the host's cores on the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return os.cpu_count() or 1
    raise ValueError(f"unknown device type {device_type!r} (use 'cuda' or 'cpu')")


def data_mesh(num_devices: Optional[int] = None,
              device_type: str = "cuda") -> List[torch.device]:
    """The first ``num_devices`` devices (default: every visible one):
    ``cuda:0 .. cuda:N-1``, or N entries of ``cpu`` (as the JAX tests'
    ``--xla_force_host_platform_device_count`` makes N virtual CPU
    devices). Raises ValueError beyond the visible count."""
    available = visible_devices(device_type)
    n = available if num_devices is None else num_devices
    if n > available:
        raise ValueError(f"requested {n} devices, only {available} available")
    if n <= 0:
        raise ValueError(f"requested {n} devices; need at least 1")
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i) for i in range(n)]


def maybe_data_mesh(device_type: str = "cuda") -> Optional[List[torch.device]]:
    """Every visible card when there is more than one, else None (one
    device). The CPU counts as one device unless a count is asked of
    ``data_mesh``."""
    if device_type == "cuda" and visible_devices("cuda") > 1:
        return data_mesh(device_type="cuda")
    return None


def replicated_forward(make_forward: Callable[[torch.device], Callable],
                       devices: Sequence[torch.device]) -> Callable:
    """-> forward(x) over a replica set.

    ``make_forward(device)`` builds one replica's forward on ``device``
    (weights moved and packed there once, e.g. ``make_fast_forward`` with
    its K1 weights); it is called once per entry of ``devices``, which may
    repeat a device (``[cuda:0, cuda:0]`` splits a batch on one card). The
    forward takes a batch whose size divides by the replica count (the JAX
    rule, serve/predictor.py:79-84), runs row block i on ``devices[i]``
    and returns the blocks' results concatenated on ``devices[0]``. The
    host enqueues every block before it waits on any, so distinct cards
    work at the same time."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a replica set needs at least one device")
    forwards = [make_forward(d) for d in devices]
    n = len(devices)

    def forward(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch size {b} must divide across the {n} replicas")
        blocks = torch.split(x, b // n)
        outs = [f(blk.to(d, non_blocking=True)) for f, blk, d in zip(forwards, blocks, devices)]
        return torch.cat([o.to(devices[0]) for o in outs])

    forward.replicas = n
    return forward
