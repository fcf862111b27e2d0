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

Both packages' run dirs resume here. ``load_checkpoint`` and
``read_checkpoint_meta`` also read what the JAX package writes (the same
header with the magic ``CTPUCKPT1``, the same meta keys, its state as flax
msgpack; and its older two-file format, ``train_state.msgpack`` +
``train_meta.json``): ``io/flax_msgpack`` decodes the state without the
``msgpack`` package and ``torch_convert.from_jax_train_state`` turns it
into this package's payload, Adam moments and step counts included. The
port writes only its own format, which the JAX package cannot read; the
first time a run dir resumes from a JAX-format generation,
``keep_jax_generation`` keeps that file as ``train_ckpt.jax.bin`` (a hard
link where the filesystem has them, else a copy; a later, different JAX
generation as ``train_ckpt.jax.e<epoch>.bin``), so the run can still go on
from there on a TPU.
"""

from __future__ import annotations

import copy
import filecmp
import hashlib
import io
import json
import os
import queue
import shutil
import struct
import threading
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from crosstalk_tpu_torch.io.flax_msgpack import msgpack_restore
from crosstalk_tpu_torch.io.torch_convert import from_jax_train_state, save_pth

CKPT_DIR = "checkpoints"
CKPT_FILE = "train_ckpt.bin"
PREV_FILE = "train_ckpt.prev.bin"
JAX_KEPT_FILE = "train_ckpt.jax.bin"
_MAGIC = b"CTPUTORCHCKPT1\n"
_LEN = struct.Struct("<Q")
# the JAX package's files (crosstalk_tpu/io/checkpoint.py:47-54), read only
_JAX_MAGIC = b"CTPUCKPT1\n"
JAX_STATE_FILE = "train_state.msgpack"
JAX_META_FILE = "train_meta.json"
# the formats load_checkpoint reads; a JAX one is named in meta["source_format"]
TORCH_FORMAT, JAX_FORMAT, JAX_LEGACY_FORMAT = "torch", "jax", "jax_legacy"
_FORMAT_NAMES = {TORCH_FORMAT: "port format", JAX_FORMAT: "JAX format"}


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


def _read_header(f, path: str) -> Tuple[str, dict]:
    """Parse magic + meta length + JSON meta, leaving the position at the
    first state byte. -> (format, meta); either package's magic."""
    magic = f.read(max(len(_MAGIC), len(_JAX_MAGIC)))
    if magic.startswith(_MAGIC):
        fmt = TORCH_FORMAT
    elif magic.startswith(_JAX_MAGIC):
        fmt = JAX_FORMAT
    else:
        raise ValueError(f"{path}: not a crosstalk checkpoint of either package "
                         "(bad magic)")
    f.seek(len(_MAGIC if fmt == TORCH_FORMAT else _JAX_MAGIC))
    raw_len = f.read(_LEN.size)
    if len(raw_len) < _LEN.size:
        raise ValueError(f"{path}: truncated header")
    (meta_len,) = _LEN.unpack(raw_len)
    # checked before the read: a corrupt length would ask read() for exabytes
    if meta_len > os.fstat(f.fileno()).st_size - f.tell():
        raise ValueError(f"{path}: truncated meta block")
    raw_meta = f.read(meta_len)
    return fmt, json.loads(raw_meta.decode("utf-8"))


def _format_name(path: str) -> str:
    """The format an unreadable generation claims, for error messages."""
    try:
        with open(path, "rb") as f:
            return _FORMAT_NAMES[_read_header(f, path)[0]]
    except (OSError, ValueError):
        return "unknown format"


def _check_digest(path: str, data: bytes, meta: dict, fmt: str) -> None:
    """The port always embeds the digest; JAX checkpoints written before it
    had one carry none (crosstalk_tpu/io/checkpoint.py:131-135)."""
    expect = meta.get("state_sha256")
    if fmt != TORCH_FORMAT and expect is None:
        return
    if hashlib.sha256(data).hexdigest() != expect:
        raise ValueError(f"{path}: state bytes do not match the embedded "
                         "digest (on-disk corruption)")


def _payload(fmt: str, data: bytes, map_location) -> dict:
    """State bytes of either format -> this package's payload."""
    if fmt == TORCH_FORMAT:
        return torch.load(io.BytesIO(data), map_location=map_location, weights_only=True)
    tree = msgpack_restore(data)
    params = tree.get("params") if isinstance(tree, dict) else None
    variant = "double" if isinstance(params, dict) and "bleed_branch" in params else "single"
    payload = from_jax_train_state(tree, variant)
    if map_location not in (None, "cpu"):
        payload = _map_tensors(lambda t: t.to(map_location), payload)
    return payload


def _read_generation(path: str, map_location) -> Tuple[str, dict, dict]:
    """One checkpoint file of either package -> (format, payload, meta). Raises
    ValueError on a bad magic, a truncation, a digest mismatch or a state
    this package cannot convert."""
    with open(path, "rb") as f:
        fmt, meta = _read_header(f, path)
        data = f.read()
    _check_digest(path, data, meta, fmt)
    try:
        payload = _payload(fmt, data, map_location)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if fmt != TORCH_FORMAT:
        meta.update(source_format=fmt, source_file=os.path.basename(path))
    return fmt, payload, meta


def load_checkpoint(run_dir: str, map_location="cpu") -> Optional[Tuple[dict, dict]]:
    """-> (state payload, meta) of the latest readable checkpoint, or None
    when the run has none. Reads either package's files; read from the JAX
    package's, ``meta`` gains ``source_format`` (``'jax'`` or
    ``'jax_legacy'``) and ``source_file`` (the port's own meta comes back as
    written, as ``read_checkpoint_meta`` reads it). Falls back to the
    previous generation, with a warning, when the current file is missing
    or unreadable; raises ValueError when every present generation is
    unreadable (naming each one's format and reason), or when a legacy JAX
    pair is torn."""
    ckpt_dir = os.path.join(run_dir, CKPT_DIR)
    errors = []
    for name in (CKPT_FILE, PREV_FILE):
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            continue
        try:
            fmt, payload, meta = _read_generation(path, map_location)
        except (OSError, ValueError) as e:
            errors.append(f"{name} ({_format_name(path)}): {e}")
            continue
        if name == PREV_FILE:
            warnings.warn(
                f"current checkpoint in {ckpt_dir} is missing or corrupt"
                f"{': ' + errors[0] if errors else ''}; resuming from the "
                f"previous generation ({_FORMAT_NAMES[fmt]}, "
                f"epoch {meta.get('epoch', '?')})",
                stacklevel=2,
            )
        return payload, meta
    if errors:
        raise ValueError(
            f"every checkpoint generation in {ckpt_dir} is unreadable: "
            f"{'; '.join(errors)}. Restore a readable copy of one of them to "
            "resume; a best_model .pth holds the best weights so far."
        )

    # the JAX package's two-file format (crosstalk_tpu/io/checkpoint.py:312-329)
    state_path = os.path.join(ckpt_dir, JAX_STATE_FILE)
    meta_path = os.path.join(ckpt_dir, JAX_META_FILE)
    if not (os.path.exists(state_path) and os.path.exists(meta_path)):
        return None
    with open(state_path, "rb") as f:
        data = f.read()
    with open(meta_path) as f:
        meta = json.load(f)
    expect = meta.get("state_sha256")  # absent in pre-digest checkpoints
    if expect is not None and hashlib.sha256(data).hexdigest() != expect:
        raise ValueError(
            f"torn legacy checkpoint in {ckpt_dir}: {JAX_STATE_FILE} does not "
            f"match the digest in {JAX_META_FILE} (the JAX run died between "
            "that format's two renames); a best_model .pth holds the best "
            "weights so far."
        )
    payload = _payload(JAX_FORMAT, data, map_location)
    meta["source_format"] = JAX_LEGACY_FORMAT
    meta["source_file"] = JAX_STATE_FILE
    return payload, meta


def read_checkpoint_meta(run_dir: str) -> Optional[dict]:
    """The host-side meta of the latest readable checkpoint of either
    package, from its header and JSON alone: the state bytes are neither
    read nor hashed (a status watcher polls this against a two-branch
    checkpoint of ~1.6 GB). Falls back to the previous generation, then to
    the JAX package's legacy ``train_meta.json``; None when none is
    readable, never an exception (crosstalk_tpu/io/checkpoint.py:150-171)."""
    ckpt_dir = os.path.join(run_dir, CKPT_DIR)
    for name in (CKPT_FILE, PREV_FILE):
        path = os.path.join(ckpt_dir, name)
        try:
            with open(path, "rb") as f:
                return _read_header(f, path)[1]
        except (OSError, ValueError):
            continue
    try:
        with open(os.path.join(ckpt_dir, JAX_META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _same_generation(a: str, b: str) -> bool:
    """Whether two JAX-format files hold one generation: the same file, or
    the same size and header meta with its state digest (a meta without
    one, from before the JAX package embedded it, compares the bytes)."""
    if os.path.samefile(a, b):
        return True
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        meta_a, meta_b = _read_header(fa, a)[1], _read_header(fb, b)[1]
    if meta_a != meta_b:
        return False
    return "state_sha256" in meta_a or filecmp.cmp(a, b, shallow=False)


def keep_jax_generation(run_dir: str, meta: dict) -> Optional[str]:
    """Keep the JAX-format generation a resume read (``meta`` from
    ``load_checkpoint``) before this package's first checkpoint rotates it
    away: as ``checkpoints/train_ckpt.jax.bin``, or, when that file holds
    another generation (the run went back to a TPU and returned), as
    ``train_ckpt.jax.e<epoch>.bin``. A kept file is never overwritten: a
    hard link (``os.replace`` never writes into a file, so the link keeps
    its bytes) or, where links fail, a copy. -> the path that holds the
    generation just read, or None when the resume did not read a
    single-file JAX generation (the legacy pair is never rotated). Raises
    ValueError when both names hold other generations."""
    if meta.get("source_format") != JAX_FORMAT:
        return None
    ckpt_dir = os.path.join(run_dir, CKPT_DIR)
    src = os.path.join(ckpt_dir, meta["source_file"])
    for name in (JAX_KEPT_FILE, f"train_ckpt.jax.e{meta['epoch']}.bin"):
        dst = os.path.join(ckpt_dir, name)
        if not os.path.exists(dst):
            try:
                os.link(src, dst)
            except OSError:
                tmp = f"{dst}.tmp{os.getpid()}"
                shutil.copyfile(src, tmp)
                os.replace(tmp, dst)
            return dst
        if _same_generation(src, dst):
            return dst
    raise ValueError(
        f"{src} is a JAX-format generation of epoch {meta['epoch']}, and "
        f"{JAX_KEPT_FILE} and {name} in {ckpt_dir} hold other ones; move one of "
        "those away to resume, so that no JAX generation is lost")


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
