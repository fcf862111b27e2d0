"""Host -> device input pipeline (port of crosstalk_tpu/data/pipeline.py).

  1. a one-time threaded decode of the directory into a packed float32
     (N, H, W, 2) array, held in RAM or memory-mapped from a ``.npy`` cache
     keyed by the file set's fingerprint;
  2. batches cut by permuted indices into the packed array, with the tail
     padded by index 0 and flagged by a zero ``mask``;
  3. ``device_batches`` copies each batch to the card from pinned memory
     with ``non_blocking=True``, enqueued up to two batches ahead (the JAX
     package's ``device_prefetch``), while a producer thread assembles the
     next batches straight into pinned memory;
  4. or ``DeviceDataset``: the whole split uploaded to the card once, each
     batch an ``index_select`` there, in the same order as
     ``iterate_batches``.

The decode runs in the native C++ decoder (``native/tile_loader.cpp``
through ``data/native_loader.py``: a thread pool parsing the dataset's
baseline-TIFF flavour straight into the packed buffer). A request it cannot
serve (an exotic TIFF, a bad path, a shape mismatch, no compiler) goes to
the threaded Python decoder (``data/tiff.py``), which gives the same pixels
and raises the clear errors; ``load_tiles.decoded`` counts the pairs each
decoder served, so a broken build does not hide behind the fallback.
"""

from __future__ import annotations

import collections
import collections.abc
import concurrent.futures as cf
import contextlib
import hashlib
import itertools
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from crosstalk_tpu_torch.data.index import Sample
from crosstalk_tpu_torch.data.tiff import read_tile
from crosstalk_tpu_torch.utils.profiling import span


class Batch(NamedTuple):
    """One batch. ``mask`` flags real (non-padding) samples."""

    inputs: np.ndarray   # (B, H, W, 2) float32, raw (unnormalized) pixels
    labels: np.ndarray   # (B, 1) float32 alpha
    ids: np.ndarray      # (B,) int64 image ids
    mask: np.ndarray     # (B,) float32, 1.0 = real sample, 0.0 = padding


def _fingerprint(samples: Sequence[Sample]) -> str:
    """Cache key over the exact file set + mtimes + sizes."""
    h = hashlib.sha256()
    for s in samples:
        for p in (s.mixed_path, s.source_path):
            st = os.stat(p)
            h.update(p.encode())
            h.update(f":{st.st_mtime_ns}:{st.st_size};".encode())
    return h.hexdigest()[:16]


def load_tiles(
    samples: Sequence[Sample],
    jobs: int = 1,
    out: Optional[np.ndarray] = None,
    use_native: bool = True,
) -> np.ndarray:
    """Decode all tile pairs into a packed (N, H, W, 2) float32 array with
    a pool of ``jobs`` threads: the native decoder first, the Python decoder
    when it cannot serve the request (or ``use_native=False``).

    ``load_tiles.decoded`` counts the pairs decoded natively and in Python
    (under a lock: servers and tools decode on several threads)."""
    if not samples:
        raise ValueError("load_tiles() received no samples")
    first = read_tile(samples[0].mixed_path)
    h, w = first.shape
    n = len(samples)
    if out is None:
        out = np.empty((n, h, w, 2), dtype=np.float32)

    if use_native and isinstance(out, np.ndarray) and out.flags["C_CONTIGUOUS"]:
        from crosstalk_tpu_torch.data.native_loader import load_pairs_native

        if load_pairs_native(
            [s.mixed_path for s in samples],
            [s.source_path for s in samples],
            out,
            threads=max(jobs, 1),
        ):
            _count_decoded("native", n)
            return out

    def _load(i: int) -> None:
        for c, path in ((0, samples[i].mixed_path), (1, samples[i].source_path)):
            tile = read_tile(path)
            if tile.shape != (h, w):
                raise ValueError(
                    f"inconsistent tile size: '{path}' is {tile.shape}, "
                    f"expected {(h, w)} (set by the first tile, "
                    f"'{samples[0].mixed_path}') — all tiles in a dataset "
                    "must share one size"
                )
            out[i, :, :, c] = tile

    if jobs > 1:
        with cf.ThreadPoolExecutor(max_workers=jobs) as pool:
            list(pool.map(_load, range(n)))
    else:
        for i in range(n):
            _load(i)
    _count_decoded("python", n)
    return out


load_tiles.decoded = {"native": 0, "python": 0}
_decoded_lock = threading.Lock()


def _count_decoded(decoder: str, pairs: int) -> None:
    with _decoded_lock:
        load_tiles.decoded[decoder] += pairs


class TileStore:
    """Packed decoded-tile storage for a sample list.

    With ``cache_dir`` set, the packed array lives in a memory-mapped ``.npy``
    keyed by the file set's fingerprint; otherwise it is held in RAM.
    Labels/ids are tiny and always in RAM.
    """

    def __init__(
        self,
        samples: Sequence[Sample],
        jobs: int = 1,
        cache_dir: Optional[str] = None,
    ):
        self.samples: List[Sample] = list(samples)
        self.labels = np.array(
            [[s.scalar_label] for s in self.samples], dtype=np.float32
        )
        self.ids = np.array([int(s.image_id) for s in self.samples], dtype=np.int64)

        if cache_dir is None:
            self.tiles = load_tiles(self.samples, jobs=jobs)
            return

        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"tiles_{_fingerprint(self.samples)}.npy")
        if not os.path.exists(path):
            first = read_tile(self.samples[0].mixed_path)
            shape = (len(self.samples), *first.shape, 2)
            # per-process tmp name + atomic replace: concurrent creators
            # each build their own file and the last identical one wins
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                arr = np.lib.format.open_memmap(
                    tmp, mode="w+", dtype=np.float32, shape=shape
                )
                load_tiles(self.samples, jobs=jobs, out=arr)
                arr.flush()
                del arr
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):  # failed build: no stale tmp litter
                    os.remove(tmp)
        self.tiles = np.load(path, mmap_mode="r")

    def __len__(self) -> int:
        return len(self.samples)


def _epoch_index_batches(n, batch_size, shuffle, drop_last, seed, epoch):
    """Epoch batch order: SeedSequence([seed, epoch]) permutation, drop-last
    cut, index-0 padding of the tail. Yields ``(idx[batch_size], real_rows)``."""
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        real = len(idx)
        if real < batch_size:  # pad-and-mask the tail (fixed batch shape)
            pad = np.zeros(batch_size - real, dtype=idx.dtype)
            idx = np.concatenate([idx, pad])
        yield idx, real


def iterate_batches(
    store: TileStore,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    epoch: int = 0,
    assembly_threads: int = 4,
    assemble_rows: Optional[slice] = None,
) -> "HostBatches":
    """The host batches of one pass over a TileStore (a :class:`HostBatches`:
    iterating it assembles them one by one).

    The final partial batch is padded to ``batch_size`` with a zero ``mask``
    unless ``drop_last``. Rows are copied by ``assembly_threads`` threads,
    each one block of the batch's rows; the output is the same as a plain
    row loop.

    ``assemble_rows`` (a rank's ``parallel.process_row_slice``): each batch
    holds only that row range of the global batch (inputs, labels, ids and
    mask), so a rank copies and uploads only its own rows. The JAX package
    keeps full-size host buffers with the other rows zeroed and assembles a
    global array; here each rank steps on its rows alone.
    """
    return HostBatches(store, batch_size, shuffle, drop_last, seed, epoch,
                       assembly_threads, assemble_rows)


class HostBatches:
    """One pass of host batches over a TileStore (``iterate_batches``).

    Iterating it yields numpy ``Batch``es, each assembled on the caller's
    thread when asked for. ``device_batches`` runs :meth:`assembled` on a
    producer thread instead, which on a CUDA device writes each batch's
    inputs straight into pinned memory."""

    def __init__(self, store: TileStore, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int, epoch: int, assembly_threads: int,
                 assemble_rows: Optional[slice]):
        self.store, self.batch_size = store, batch_size
        self.cut = list(_epoch_index_batches(
            len(store), batch_size, shuffle, drop_last, seed, epoch))
        self.threads = assembly_threads
        self.rows = slice(None) if assemble_rows is None else assemble_rows

    def __len__(self) -> int:
        return len(self.cut)

    def __iter__(self) -> Iterator[Batch]:
        for b in self.assembled(_fresh, {}):
            yield Batch(b.inputs.numpy(), b.labels.numpy(), b.ids, b.mask.numpy())

    def assembled(self, destination: Callable[[tuple], torch.Tensor],
                  tags: dict) -> Iterator[Batch]:
        """The batches with inputs, labels and mask as CPU tensors, each
        batch's inputs written into ``destination(shape)`` (:func:`_staged`,
        whose spans take ``tags``)."""
        store, rows = self.store, self.rows
        row_shape = store.tiles.shape[1:]
        pool = cf.ThreadPoolExecutor(self.threads) if self.threads > 1 else None
        try:
            for k, (idx, real) in enumerate(self.cut):
                idx = idx[rows]
                mask = np.zeros(self.batch_size, dtype=np.float32)
                mask[:real] = 1.0

                def fill(out: np.ndarray, idx=idx) -> None:
                    _copy_rows(store.tiles, idx, out, pool, self.threads)

                yield _staged(k, (len(idx), *row_shape), store.labels[idx],
                              store.ids[idx], mask[rows], fill, destination, tags)
        finally:
            if pool is not None:
                pool.shutdown()


def _staged(k: int, shape: tuple, labels: np.ndarray, ids: np.ndarray,
            mask: np.ndarray, fill: Callable[[np.ndarray], None],
            destination: Callable[[tuple], torch.Tensor], tags: dict) -> Batch:
    """Batch ``k``, its inputs written by ``fill`` into ``destination(shape)``.

    Spans (``utils/profiling.span``; attributes ``batch`` and ``tags``):

    * ``crosstalk.pipeline.stage`` (``bytes``): the destination and the
      labels and mask as tensors. The labels and mask, a few hundred bytes,
      stay pageable: CUDA copies them to its own staging memory before an
      asynchronous copy returns;
    * ``crosstalk.pipeline.assemble`` (``rows``, ``bytes``): ``fill``.

    Neither is twinned: on a producer thread the profiler records no
    ``record_function`` range."""
    nbytes = int(np.prod(shape)) * 4
    with span("crosstalk.pipeline.stage", host_only=False, batch=k,
              bytes=nbytes + labels.nbytes + mask.nbytes, **tags):
        inputs = destination(shape)
        labels, mask = torch.from_numpy(labels), torch.from_numpy(mask)
    with span("crosstalk.pipeline.assemble", host_only=False, batch=k,
              rows=shape[0], bytes=nbytes, **tags):
        fill(inputs.numpy())
    return Batch(inputs, labels, ids, mask)


def _given(batches: Iterable[Batch], destination: Callable[[tuple], torch.Tensor],
           tags: dict) -> Iterator[Batch]:
    """Host batches from any iterable, as :meth:`HostBatches.assembled`
    hands them over: the inputs copied into ``destination``."""
    for k, b in enumerate(batches):
        yield _staged(k, b.inputs.shape, b.labels, b.ids, b.mask,
                      lambda out, given=b.inputs: np.copyto(out, given),
                      destination, tags)


def _fresh(shape: tuple) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32)


def _copy_rows(tiles, idx: np.ndarray, out: np.ndarray, pool, threads: int) -> None:
    """``out[j] = tiles[idx[j]]`` for every j: one ``np.take`` per block of
    ``out``'s rows, the blocks split over ``pool``'s ``threads`` threads (one
    block on this thread without a pool). A block is one call into numpy,
    so a copy thread takes the interpreter lock a few times a batch, not
    once a row, and leaves it to the engine's thread as it launches."""

    def copy(block: slice) -> None:
        # "clip" writes straight into out ("raise" goes through a buffer);
        # every index is in range
        np.take(tiles, idx[block], axis=0, out=out[block], mode="clip")

    if pool is None:
        copy(slice(None))
    else:
        cuts = np.linspace(0, len(idx), threads + 1).astype(int)
        list(pool.map(copy, [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]))


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


_PREFETCH_DEPTH = 2  # batches whose host -> device copy is in flight
_AHEAD = 2  # host batches the producer thread holds ready for the consumer
# pinned input buffers a pass uses in turn: those ready, the one being
# assembled, and the consumer's, whose copy it has enqueued
_SLOTS = _AHEAD + 2


def device_batches(batches: Iterable[Batch], device: torch.device,
                   tags: Optional[dict] = None) -> Iterator[Batch]:
    """Move ``inputs``/``labels``/``mask`` of each batch to ``device``
    (``ids`` stay on the host), enqueueing up to two batches ahead.

    A producer thread stages the batches up to ``_AHEAD`` ahead of this one
    (``_assembled_ahead``): it assembles a ``HostBatches``
    (``iterate_batches``) straight into each batch's destination, and
    copies any other iterable's inputs into it. On a CUDA device the
    destination is pinned memory (``_PinnedSlots``) and the copies go with
    ``non_blocking=True``, so the host returns before a copy ends; they run
    in order with the compute on the current stream. Their enqueue
    (``.to``) is in no span: a range that launches a copy would count as
    device activity in the profiler's timeline. ``tags`` (a pass's
    attributes) go on the producer's spans, which have no parent on their
    thread."""
    pin = device.type == "cuda"
    inflight: collections.deque = collections.deque()
    ready = _assembled_ahead(batches, device, tags or {})
    with contextlib.closing(ready):
        for b in ready:
            inputs, labels, mask = (t.to(device, non_blocking=pin)
                                    for t in (b.inputs, b.labels, b.mask))
            inflight.append(Batch(inputs, labels, b.ids, mask))
            if len(inflight) > _PREFETCH_DEPTH:
                yield inflight.popleft()
    while inflight:
        yield inflight.popleft()


class _PinnedSlots:
    """The pinned input buffers of one pass on a CUDA device, used in turn.

    The consumer gives a slot back once it has enqueued the copy that reads
    it, with an event recorded behind that copy on the copy's stream; the
    producer waits for that event before it writes the slot again. The
    producer runs at most ``_AHEAD`` batches ahead of the consumer, so
    ``_SLOTS`` slots always leave one given back: a pass allocates them
    once, and after the first pass PyTorch's caching pinned-memory
    allocator hands back the same blocks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.made = 0
        self.free: collections.deque = collections.deque()  # (inputs, copied)

    def take(self, shape: tuple) -> torch.Tensor:
        """The producer's: a buffer of ``shape`` no copy still reads."""
        while self.made >= _SLOTS and self.free:
            inputs, copied = self.free.popleft()
            if inputs.shape == shape:
                copied.synchronize()
                return inputs
        self.made += 1
        return torch.empty(shape, dtype=torch.float32, pin_memory=True)

    def give_back(self, inputs: torch.Tensor) -> None:
        """The consumer's, after it has enqueued the copy of ``inputs``."""
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        self.free.append((inputs, copied))


class _Raised:
    """An error of the producer thread, handed to the consumer to raise."""

    def __init__(self, error: BaseException):
        self.error = error


_END = object()  # the producer's last item after an iterable of no length


def _assembled_ahead(batches: Iterable[Batch], device: torch.device,
                     tags: dict) -> Iterator[Batch]:
    """The batches staged on a producer thread that holds up to ``_AHEAD``
    of them ready; yields them in order on this thread.

    An error of the producer is raised here. Closing this generator (a
    ``break`` or an error in the consumer) stops the producer and joins it
    and its assembly pool, so a pass leaves no thread behind.

    Span ``crosstalk.pipeline.wait`` (twinned; attributes ``batch`` and
    ``ready``, true when the batch was already there): one per batch, this
    thread's wait for it, and one more for the end of an iterable of no
    length."""
    slots = _PinnedSlots(device) if device.type == "cuda" else None
    destination = _fresh if slots is None else slots.take
    source = (batches.assembled(destination, tags) if isinstance(batches, HostBatches)
              else _given(batches, destination, tags))
    count = len(batches) if isinstance(batches, collections.abc.Sized) else None
    assembled: queue.Queue = queue.Queue(_AHEAD)
    stop = threading.Event()

    def produce() -> None:
        try:
            for b in source:
                assembled.put(b)
                del b  # the consumer's alone now
                if stop.is_set():
                    return
            assembled.put(_END)
        except BaseException as exc:  # raised again on the consumer's thread
            assembled.put(_Raised(exc))
        finally:
            source.close()  # shuts its assembly pool down

    producer = threading.Thread(target=produce, name="crosstalk-batch-producer",
                                daemon=True)
    producer.start()
    try:
        for k in itertools.count() if count is None else range(count):
            with span("crosstalk.pipeline.wait", host_only=True, batch=k,
                      ready=not assembled.empty()):
                item = assembled.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
            if slots is not None:  # its copy is enqueued
                slots.give_back(item.inputs)
    finally:
        stop.set()
        while producer.is_alive():  # unblock a producer waiting on a full queue
            try:
                assembled.get(timeout=0.01)
            except queue.Empty:
                pass
        producer.join()


class DeviceDataset:
    """Device-resident dataset: one upload, then on-device per-batch gathers
    (port of the JAX package's ``DeviceDataset``).

    Tiles and labels move to ``device`` once; each epoch uploads its index
    order once and every batch is an ``index_select`` on the device, with no
    per-step host-to-device copy and no host work in the loop. The order and
    padding are ``iterate_batches``'s (same ``_epoch_index_batches``), so
    host- and device-resident runs see the same batch sequence.
    """

    def __init__(self, store: TileStore, device: torch.device):
        self.n = len(store)
        self.device = torch.device(device)
        self.tiles = torch.from_numpy(np.ascontiguousarray(store.tiles)).to(self.device)
        self.labels = torch.from_numpy(store.labels).to(self.device)
        self.ids = store.ids  # host-side (only eval consumers need ids)

    def __len__(self) -> int:
        return self.n

    @staticmethod
    def nbytes(store: TileStore) -> int:
        """Device-memory footprint of residency for this store."""
        return int(store.tiles.nbytes) + int(store.labels.nbytes)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        epoch: int = 0,
    ) -> Iterator[Batch]:
        """Yield Batches whose inputs, labels and mask live on the device
        (``ids`` stay on the host); the same order and padding contract as
        ``iterate_batches``."""
        cut = list(_epoch_index_batches(
            self.n, batch_size, shuffle, drop_last, seed, epoch))
        if not cut:
            return
        order = torch.from_numpy(np.stack([idx for idx, _ in cut]))
        if self.device.type == "cuda":
            order = order.pin_memory()
        order = order.to(self.device, non_blocking=True)
        slot = torch.arange(batch_size, device=self.device)
        for k, (idx, real) in enumerate(cut):
            mask = (slot < real).to(torch.float32)
            yield Batch(self.tiles.index_select(0, order[k]),
                        self.labels.index_select(0, order[k]),
                        self.ids[idx], mask)
