"""Training checkpoints and resume (the port's counterpart of
crosstalk_tpu/io/checkpoint.py, same design, its own format).

Every epoch (``--checkpoint_every``) writes one resume checkpoint: the
model's ``state_dict`` (parameters and BN running statistics), the
optimizer's ``state_dict`` (Adam moments and step counts), the train step
counter and the RNG state, with the host-side meta (epoch, schedule, loss
history). ``--resume <run_dir>`` continues from it.

Format: ONE file per checkpoint — a header (magic + meta-JSON length), the
meta as JSON (which embeds a sha256 of the state bytes), then the state as
a ``torch.save`` payload. It is written to a temp file, fsync'd, and lands
with one ``os.replace``, so a kill at any instant leaves the old checkpoint
or the new one, never a mix. The generation it replaces is kept as
``train_ckpt.prev.bin``, and ``load_checkpoint`` falls back to it (with a
warning) when the current file is missing or fails its digest.

The JAX package writes its state as flax msgpack, which this package does
not read, and it cannot read this one: the ``.pth`` files written beside
them are what both packages load.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import os
import queue
import struct
import threading
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from crosstalk_tpu_torch.io.torch_convert import save_pth

CKPT_DIR = "checkpoints"
CKPT_FILE = "train_ckpt.bin"
PREV_FILE = "train_ckpt.prev.bin"
_MAGIC = b"CTPUTORCHCKPT1\n"
_LEN = struct.Struct("<Q")


def state_payload(state, seed: int) -> dict:
    """A TrainState -> the dict a checkpoint stores. The flips and dropout
    masks are functions of (seed, step), so the seed and the step are all
    of the RNG state."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "rng": {"seed": seed},
    }


def restore_state(state, payload: dict) -> None:
    """Load a checkpoint payload into a TrainState in place."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])


def save_checkpoint(run_dir: str, payload: dict, meta: dict) -> str:
    """Persist (state payload, host metadata) as ONE atomic unit; the
    generation it replaces is rotated to ``train_ckpt.prev.bin``."""
    ckpt_dir = os.path.join(run_dir, CKPT_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)

    buf = io.BytesIO()
    torch.save(payload, buf)
    data = buf.getbuffer()
    meta = dict(meta)
    meta["state_sha256"] = hashlib.sha256(data).hexdigest()
    meta_bytes = json.dumps(meta).encode("utf-8")

    path = os.path.join(ckpt_dir, CKPT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(_LEN.pack(len(meta_bytes)))
        f.write(meta_bytes)
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        # if we die between these two renames, prev holds the same bytes
        # the current file held, and load_checkpoint falls back to it
        os.replace(path, os.path.join(ckpt_dir, PREV_FILE))
    os.replace(tmp, path)
    return ckpt_dir


def _read_header(f, path: str) -> dict:
    """Parse magic + meta length + JSON meta, leaving the position at the
    first state byte."""
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{path}: not a crosstalk_tpu_torch checkpoint (bad magic)")
    raw_len = f.read(_LEN.size)
    if len(raw_len) < _LEN.size:
        raise ValueError(f"{path}: truncated header")
    (meta_len,) = _LEN.unpack(raw_len)
    raw_meta = f.read(meta_len)
    if len(raw_meta) < meta_len:
        raise ValueError(f"{path}: truncated meta block")
    return json.loads(raw_meta.decode("utf-8"))


def _read_ckpt_file(path: str) -> Tuple[dict, bytes]:
    """One checkpoint file -> (meta, state bytes). Raises ValueError on a
    bad magic, a truncation or a digest mismatch: the atomic writer cannot
    produce any of them, so each means on-disk corruption."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        data = f.read()
    if hashlib.sha256(data).hexdigest() != meta.get("state_sha256"):
        raise ValueError(f"{path}: state bytes do not match the embedded "
                         "digest (on-disk corruption)")
    return meta, data


def load_checkpoint(run_dir: str, map_location="cpu") -> Optional[Tuple[dict, dict]]:
    """-> (state payload, meta) of the latest readable checkpoint, or None
    when the run has none. Falls back to the previous generation, with a
    warning, when the current file is missing or corrupt; raises ValueError
    when every present generation is unreadable."""
    ckpt_dir = os.path.join(run_dir, CKPT_DIR)
    errors = []
    for name in (CKPT_FILE, PREV_FILE):
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            continue
        try:
            meta, data = _read_ckpt_file(path)
        except (OSError, ValueError) as e:
            errors.append(str(e))
            continue
        if name == PREV_FILE:
            warnings.warn(
                f"current checkpoint in {ckpt_dir} is missing or corrupt"
                f"{': ' + errors[0] if errors else ''}; resuming from the "
                f"previous generation (epoch {meta.get('epoch', '?')})",
                stacklevel=2,
            )
        payload = torch.load(io.BytesIO(data), map_location=map_location,
                             weights_only=True)
        return payload, meta
    if errors:
        raise ValueError(
            f"every checkpoint generation in {ckpt_dir} is unreadable "
            f"({'; '.join(errors)}). Delete the checkpoints/ dir to restart "
            "from scratch, or restore a best_model .pth."
        )
    return None


def _map_tensors(fn, tree):
    """Rebuild a nested dict/list/tuple with ``fn`` applied to its tensors;
    other leaves (numbers, strings, None) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _snapshot(tree):
    """Clone every tensor of a payload on its device, in the order of the
    current stream: the copies are immune to the next optimizer step's
    in-place updates. -> (copy, event or None); a CUDA event marks when the
    copies are done."""
    snap = _map_tensors(lambda t: t.detach().clone(), tree)
    event = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        event = torch.cuda.Event()
        event.record()
    return snap, event


class AsyncCheckpointWriter:
    """Overlap checkpoint device-to-host copies and disk writes with training.

    Each ``submit_*`` clones the state on its device, on the training
    stream, and records an event; a background thread waits on that event,
    copies the clone to the host and writes the file while the next epoch
    trains. One job at most waits in the queue (each holds one copy of the
    state on the device); a further submit blocks until the writer catches
    up. ``wait()`` blocks until everything submitted is durable. A writer
    error is raised on the next submit or wait. Files and atomicity are
    those of ``save_checkpoint``.
    """

    def __init__(self):
        self._jobs: "queue.Queue" = queue.Queue(maxsize=1)
        self._exc: Optional[BaseException] = None
        self._exc_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                job()
            except BaseException as e:  # surfaced on the next submit/wait
                with self._exc_lock:
                    self._exc = e
            finally:
                self._jobs.task_done()

    def _raise_pending(self):
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError("async checkpoint write failed") from exc

    def _submit(self, tree, write: Callable[[dict], None]) -> None:
        self._raise_pending()
        snap, event = _snapshot(tree)

        def job():
            if event is not None:
                event.synchronize()
            write(_map_tensors(lambda t: t.cpu(), snap))

        self._jobs.put(job)

    def submit_checkpoint(self, run_dir: str, payload: dict, meta: dict) -> None:
        """Async ``save_checkpoint``; ``meta`` is deep-copied at call time."""
        meta = copy.deepcopy(meta)
        self._submit(payload, lambda p: save_checkpoint(run_dir, p, meta))

    def submit_pth(self, path: str, state_dict: Dict[str, torch.Tensor]) -> None:
        """Async ``torch_convert.save_pth`` (the best-model ``.pth``)."""
        self._submit(state_dict, lambda sd: save_pth(path, sd))

    def wait(self) -> None:
        """Block until every submitted write is durable; raise on failure."""
        self._jobs.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain outstanding writes, stop the worker thread, and raise a
        writer error."""
        if self._thread.is_alive():
            self._jobs.join()
            self._jobs.put(None)
            self._thread.join()
        self._raise_pending()
