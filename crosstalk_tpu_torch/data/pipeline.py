"""Host -> device input pipeline (port of crosstalk_tpu/data/pipeline.py).

  1. a one-time threaded decode of the directory into a packed float32
     (N, H, W, 2) array, held in RAM or memory-mapped from a ``.npy`` cache
     keyed by the file set's fingerprint;
  2. batches cut by permuted indices into the packed array, with the tail
     padded by index 0 and flagged by a zero ``mask``;
  3. ``device_batches`` copies each batch to the card from pinned memory
     with ``non_blocking=True``, enqueued up to two batches ahead (the JAX
     package's ``device_prefetch``);
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
import concurrent.futures as cf
import hashlib
import os
import threading
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from crosstalk_tpu_torch.data.index import Sample
from crosstalk_tpu_torch.data.tiff import read_tile


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
) -> Iterator[Batch]:
    """Yield host batches from a TileStore.

    The final partial batch is padded to ``batch_size`` with a zero ``mask``
    unless ``drop_last``. Rows are copied in sorted-source order (sequential
    walks of a memory-mapped cache) by ``assembly_threads`` threads; the
    output is the same as a plain row loop.

    ``assemble_rows`` (a rank's ``parallel.process_row_slice``): each batch
    holds only that row range of the global batch (inputs, labels, ids and
    mask), so a rank copies and uploads only its own rows. The JAX package
    keeps full-size host buffers with the other rows zeroed and assembles a
    global array; here each rank steps on its rows alone.
    """
    pool = (
        cf.ThreadPoolExecutor(assembly_threads)
        if assembly_threads > 1 else None
    )
    rows = slice(None) if assemble_rows is None else assemble_rows
    try:
        for idx, real in _epoch_index_batches(
            len(store), batch_size, shuffle, drop_last, seed, epoch
        ):
            mask = np.zeros(batch_size, dtype=np.float32)
            mask[:real] = 1.0
            idx, mask = idx[rows], mask[rows]
            inputs = np.empty((len(idx), *store.tiles.shape[1:]), np.float32)
            src_sorted = np.argsort(idx, kind="stable")

            def copy_rows(dsts):
                for j in dsts:
                    inputs[j] = store.tiles[idx[j]]

            if pool is None:
                copy_rows(src_sorted)
            else:
                chunks = np.array_split(src_sorted, assembly_threads)
                list(pool.map(copy_rows, chunks))
            yield Batch(inputs, store.labels[idx], store.ids[idx], mask)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


_PREFETCH_DEPTH = 2  # batches whose host -> device copy is in flight


def device_batches(batches: Iterator[Batch], device: torch.device) -> Iterator[Batch]:
    """Move ``inputs``/``labels``/``mask`` of each batch to ``device``
    (``ids`` stay on the host), enqueueing up to two batches ahead.

    On a CUDA device the arrays go through pinned host memory with
    ``non_blocking=True``, so the host returns before the copy ends and can
    assemble the next batch. The copies run in order with the compute on
    the current stream. PyTorch's pinned-memory allocator holds each pinned
    buffer until the copy that reads it has completed."""
    pin = device.type == "cuda"

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    queue: collections.deque = collections.deque()
    for b in batches:
        queue.append(Batch(put(b.inputs), put(b.labels), b.ids, put(b.mask)))
        if len(queue) > _PREFETCH_DEPTH:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


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
