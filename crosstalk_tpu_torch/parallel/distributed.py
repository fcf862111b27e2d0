"""Multi-process data parallelism (port of crosstalk_tpu/parallel/distributed.py).

A **rank** is one process that drives one device, under ``torch.distributed``:
NCCL on CUDA cards, Gloo on the CPU. Training and the validation inside it
run as ranks: the train CLI's ``--num_devices N`` starts N local ranks
(``launch_local``), ``--multihost`` makes the process one rank of a cluster.

  * ``initialize()`` joins the cluster. Nothing on a GPU host tells a
    process of its cluster, so the coordinator address, the process count
    and this process's id come from the arguments or from the
    ``CROSSTALK_COORDINATOR`` / ``CROSSTALK_NUM_PROCESSES`` /
    ``CROSSTALK_PROCESS_ID`` environment variables, as in the JAX package.
  * per-rank batch assembly: every rank copies only ITS rows of each global
    batch (``process_row_slice``, honoured by
    ``data.pipeline.iterate_batches(assemble_rows=...)``) to the host buffer
    and to its device. The JAX package then wraps the rows as one global
    array (``make_global_batch``); here each rank keeps its own rows, and
    the collectives of the train and validation steps (DDP's gradient mean,
    the cross-replica BatchNorm, the loss and error sums) make the step a
    function of the global batch. So there is no ``make_global_batch``.
  * rank gating: artifacts, logs and prints belong to rank 0 (``is_primary``);
    the losses the steps return are already global, so every rank's control
    flow (best model, early stop, schedule) stays in lockstep.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# the rendezvous and collective timeout; CROSSTALK_DIST_TIMEOUT (seconds)
# overrides it, e.g. in tests that want a failed rendezvous to end quickly
DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def cluster_spec(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None):
    """-> (coordinator address, process count, process id) from the
    arguments, else the CROSSTALK_* variables. Raises ValueError when one is
    missing or the id is out of range."""
    coordinator_address = coordinator_address or os.environ.get("CROSSTALK_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("CROSSTALK_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("CROSSTALK_PROCESS_ID")
    missing = [name for name, value in (
        ("the coordinator address (--coordinator_address / CROSSTALK_COORDINATOR)",
         coordinator_address),
        ("the process count (--num_processes / CROSSTALK_NUM_PROCESSES)", num_processes),
        ("this process's id (--process_id / CROSSTALK_PROCESS_ID)", process_id),
    ) if value is None]
    if missing:
        raise ValueError("a multi-process run needs " + ", ".join(missing)
                         + "; nothing on this host detects them")
    if num_processes <= 0:
        raise ValueError(f"the process count must be positive, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside 0..{num_processes - 1}")
    return coordinator_address, num_processes, process_id


def default_backend(device_type: str) -> str:
    """NCCL for CUDA tensors, Gloo for CPU tensors."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: str = "cuda",
    timeout_s: Optional[float] = None,
) -> dist.ProcessGroup:
    """Join the multi-process cluster -> the world process group.

    ``dist.init_process_group`` over ``tcp://<coordinator_address>`` (rank 0
    listens there) with an explicit timeout. ``backend`` defaults to NCCL
    when ``device_type`` is ``'cuda'`` and to Gloo on the CPU; Gloo on CUDA
    tensors works too (two ranks may then share one card). Idempotent: a
    process already in a group gets that group back.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    address, world, rank = cluster_spec(coordinator_address, num_processes, process_id)
    if timeout_s is None:
        timeout_s = float(os.environ.get("CROSSTALK_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend=backend or default_backend(device_type),
        init_method=f"tcp://{address}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.group.WORLD


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """The ranks in ``group`` (1 outside a process group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group: Optional[dist.ProcessGroup] = None) -> int:
    """This process's rank in ``group`` (0 outside a process group)."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def is_primary(group: Optional[dist.ProcessGroup] = None) -> bool:
    """True on the process that owns artifacts and logging (rank 0)."""
    return rank(group) == 0


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK``
    when set, else the rank modulo the visible card count."""
    value = _env_int("LOCAL_RANK")
    if value is not None:
        return value
    return rank() % max(torch.cuda.device_count(), 1)


def rank_device(device_type: str) -> torch.device:
    """The device a rank drives: ``cuda:<local rank>`` on a card, ``cpu``
    on the CPU."""
    if device_type == "cuda":
        return torch.device(f"cuda:{local_rank()}")
    if device_type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device type {device_type!r} (use 'cuda' or 'cpu')")


def process_row_slice(global_batch_size: int,
                      group: Optional[dist.ProcessGroup] = None) -> slice:
    """This rank's contiguous row range of every global batch: rank p owns
    rows ``[p * local, (p + 1) * local)``. Raises on a batch that does not
    divide by the world size, as the JAX package does."""
    n = world_size(group)
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch size {global_batch_size} must divide across "
            f"{n} processes"
        )
    local = global_batch_size // n
    p = rank(group)
    return slice(p * local, (p + 1) * local)


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must live: the current card for NCCL,
    the host for Gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _map_leaves(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def allgather_to_host(tree: Any, group: Optional[dist.ProcessGroup] = None) -> Any:
    """Concatenate every rank's rows of each tensor or array in ``tree``
    (dicts, lists and tuples of them) along dim 0, in rank order -> the
    same numpy arrays on every rank. Every rank of ``group`` (None: the
    world) calls it with the same structure and shapes. Outside a process
    group, or in a group of one, it only converts to numpy."""
    def as_numpy(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    if world_size(group) == 1:
        return _map_leaves(as_numpy, tree)
    n, device = world_size(group), _comm_device(group)

    def gather(a):
        t = torch.as_tensor(as_numpy(a)).to(device)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts).cpu().numpy()

    return _map_leaves(gather, tree)


def free_port() -> int:
    """A localhost TCP port that is free now (another process may take it
    before the rendezvous binds it; callers retry with a fresh one)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_rank_entry(index: int, fn: Callable, world: int, address: str, args) -> None:
    os.environ.update({
        "CROSSTALK_COORDINATOR": address,
        "CROSSTALK_NUM_PROCESSES": str(world),
        "CROSSTALK_PROCESS_ID": str(index),
        "LOCAL_RANK": str(index),
    })
    code = fn(*args)
    if code:
        raise SystemExit(code)


def launch_local(fn: Callable, world: int, *args) -> int:
    """Run ``fn(*args)`` in ``world`` fresh processes of this host, rank i
    with the CROSSTALK_* variables of a cluster on a free localhost port
    and ``LOCAL_RANK=i`` (``fn`` calls ``initialize()``). -> 0 when every
    rank returned 0 or None, else 1; a failing rank stops the others.
    ``fn`` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    address = f"localhost:{free_port()}"
    try:
        mp.start_processes(_local_rank_entry, args=(fn, world, address, args),
                           nprocs=world, join=True, start_method="spawn")
    except mp.ProcessExitedException:
        return 1
    except mp.ProcessRaisedException as e:
        print(f"Error: a rank failed:\n{e}")
        return 1
    return 0
