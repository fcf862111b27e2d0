"""Dynamic request batching for online inference (the port's copy of
crosstalk_tpu/serve/batcher.py; numpy only).

The device runs at a FIXED, small set of batch shapes. The batcher
coalesces concurrently-arriving requests (each any number of tiles) into
fixed-size batches, padding the tail of a flush with zero tiles rather
than introducing a new shape. A request larger than the batch size spans
several device calls; a burst of single-tile requests shares one call.

By default there is exactly one shape (``batch_size``). Optional
``bucket_sizes`` adds smaller shapes: a partially-filled flush dispatches
at the smallest bucket that holds it, so a lone 1-tile request under
light traffic pays a bucket-sized device call and host-to-device copy
instead of a full ``batch_size`` one. The predictor warms every bucket up
front; the batcher never invents a shape.

Flush policy: a batch is dispatched as soon as it is full, or when the
oldest queued row has waited ``max_delay_ms`` (latency bound under light
traffic). All device work happens on the single dispatcher thread, so the
predictor sees one caller and one CUDA stream.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict

import numpy as np


def parse_batch_buckets(spec: str, batch_size: int):
    """``"8,32"`` -> sorted unique bucket list, validated against
    ``batch_size``. Raises ValueError with a user-facing message; the serve
    CLI validates with it before it loads any weights."""
    try:
        buckets = sorted({int(tok) for tok in spec.split(",") if tok.strip()})
    except ValueError:
        raise ValueError(
            f"batch buckets must be comma-separated integers, got {spec!r}"
        )
    if not buckets or buckets[0] <= 0 or buckets[-1] > batch_size:
        raise ValueError(
            f"batch bucket values must be in 1..batch_size ({batch_size}), "
            f"got {buckets}"
        )
    return buckets


class _Pending:
    __slots__ = ("tiles", "future", "results", "done", "arrived")

    def __init__(self, tiles: np.ndarray):
        self.tiles = tiles
        self.future: Future = Future()
        self.results = np.empty((tiles.shape[0],), np.float32)
        self.done = 0
        self.arrived = time.monotonic()

    @property
    def remaining(self) -> int:
        return self.tiles.shape[0] - self.done


class DynamicBatcher:
    """Coalesce concurrent prediction requests into fixed-size batches.

    ``predict_fn`` takes a float32 ``(n, H, W, C)`` array and returns
    ``(n,)`` float32 predictions; ``n`` is always ``batch_size`` or one of
    ``bucket_sizes`` (so a predictor can warm up every shape it will ever
    see).
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        batch_size: int,
        tile_shape,
        max_delay_ms: float = 5.0,
        dtype=np.float32,
        bucket_sizes=None,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        buckets = sorted({int(b) for b in (bucket_sizes or ())} | {int(batch_size)})
        if buckets[0] <= 0:
            raise ValueError(f"bucket sizes must be positive, got {buckets}")
        if buckets[-1] != batch_size:
            raise ValueError(
                f"bucket sizes {buckets} must not exceed batch_size {batch_size}"
            )
        self._buckets = tuple(buckets)
        self._predict = predict_fn
        self._batch_size = batch_size
        self._tile_shape = tuple(tile_shape)  # (H, W, C)
        # transport dtype of the assembled device batch: float16 halves the
        # host->device bytes (the serving bottleneck on bandwidth-limited
        # links); predict_fn must accept it (predictor casts on device)
        self._dtype = np.dtype(dtype)
        self._max_delay = max_delay_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        # serializes the closed-check-then-enqueue in submit() against
        # close()'s set-closed-then-sentinel: without it an item could land
        # AFTER the shutdown sentinel and its Future would never resolve
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "tiles": 0,
            "batches": 0,
            "padded_rows": 0,
            "capacity_rows": 0,
            "device_seconds": 0.0,
            "reloads": 0,
        }
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="crosstalk-batcher", daemon=True
        )
        self._thread.start()

    # ---- client side ----------------------------------------------------

    def submit(self, tiles: np.ndarray) -> Future:
        """Queue ``(n, H, W, C)`` tiles; the Future resolves to ``(n,)``
        float32 alphas (or raises the batch's prediction error)."""
        tiles = np.ascontiguousarray(tiles, dtype=self._dtype)
        if tiles.ndim != 4 or tiles.shape[1:] != self._tile_shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self._tile_shape))}) tiles, "
                f"got {tiles.shape}"
            )
        if tiles.shape[0] == 0:
            raise ValueError("empty request")
        item = _Pending(tiles)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(item)
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["tiles"] += tiles.shape[0]
        return item.future

    def swap_predict_fn(self, predict_fn) -> None:
        """Atomically replace the model behind the batcher (hot reload).

        The dispatcher reads ``self._predict`` once per batch, so an
        in-flight batch completes on the model it started with and every
        later batch uses the new one — no request is dropped. Swap
        granularity is the BATCH: a single request larger than the batch
        size that straddles the swap has its later rows scored by the new
        model (both models are valid checkpoints of the same task, so this
        only matters if the caller assumes one-model-per-request — split
        requests at the batch size to guarantee that). Build and warm the
        new function BEFORE swapping (make_predictor's warmup) so the first
        post-swap batch does not stall on it.
        """
        self._predict = predict_fn
        with self._stats_lock:
            self._stats["reloads"] += 1

    def stats(self) -> Dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["batch_size"] = self._batch_size
        if len(self._buckets) > 1:
            out["bucket_sizes"] = list(self._buckets)
        out["max_delay_ms"] = self._max_delay * 1000.0
        out["transport_dtype"] = self._dtype.name
        if out["capacity_rows"]:
            out["mean_batch_occupancy"] = (
                1.0 - out["padded_rows"] / out["capacity_rows"]
            )
        return out

    def close(self) -> None:
        """Flush outstanding work and stop the dispatcher thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join()

    # ---- dispatcher thread ----------------------------------------------

    def _drain_queue(self, backlog, timeout) -> bool:
        """Move queued items into ``backlog``; block up to ``timeout`` for
        the first one. Returns False when the shutdown sentinel arrives."""
        try:
            item = self._queue.get(timeout=timeout)
        except queue.Empty:
            return True
        while True:
            if item is None:
                return False
            backlog.append(item)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return True

    def _run(self) -> None:
        backlog: "collections.deque[_Pending]" = collections.deque()
        running = True
        while running or backlog:
            if running:
                if backlog:
                    # Wait for more rows only until the oldest row's deadline.
                    deadline = backlog[0].arrived + self._max_delay
                    rows = sum(p.remaining for p in backlog)
                    if rows < self._batch_size:
                        wait = deadline - time.monotonic()
                        if wait > 0:
                            running = self._drain_queue(backlog, wait)
                else:
                    running = self._drain_queue(backlog, None)
                    if not backlog:
                        continue
            rows = sum(p.remaining for p in backlog)
            if rows == 0:
                backlog.clear()
                continue
            if running and rows < self._batch_size and (
                time.monotonic() < backlog[0].arrived + self._max_delay
            ):
                continue  # not full and the latency bound hasn't expired
            self._dispatch_one(backlog)

    def _dispatch_one(self, backlog: "collections.deque[_Pending]") -> None:
        # Smallest warmed-up shape that holds the pending rows (capped
        # at batch_size; an overfull backlog just spans several dispatches).
        rows = min(sum(p.remaining for p in backlog), self._batch_size)
        size = next(b for b in self._buckets if b >= rows)
        took = []  # (pending, dst_start, src_start, n)
        try:
            # batch ASSEMBLY is inside the guard too: an unexpected failure
            # here (e.g. MemoryError on the 33 MB batch buffer under
            # pressure) must resolve the touched Futures, not kill the
            # dispatcher thread and strand every queued request while
            # /healthz stays green
            batch = np.zeros((size,) + self._tile_shape, self._dtype)
            filled = 0
            while backlog and filled < size:
                p = backlog[0]
                n = min(p.remaining, size - filled)
                batch[filled : filled + n] = p.tiles[p.done : p.done + n]
                took.append((p, filled, p.done, n))
                p.done += n
                filled += n
                if p.remaining == 0:
                    backlog.popleft()
            t0 = time.monotonic()
            preds = np.asarray(self._predict(batch), np.float32).reshape(-1)
            if preds.shape[0] != size:
                raise RuntimeError(
                    f"predict_fn returned {preds.shape[0]} rows, "
                    f"expected {size}"
                )
        except Exception as e:  # resolve every touched request with the error
            for p, _, _, _ in took:
                if not p.future.done():
                    p.future.set_exception(e)
                if p in backlog:  # drop its unscheduled rows — the request
                    backlog.remove(p)  # is already resolved
            if not took and backlog:
                # nothing was assembled (the buffer allocation itself
                # failed): fail the oldest request so a persistent error
                # drains the backlog instead of hot-looping on it
                p = backlog.popleft()
                if not p.future.done():
                    p.future.set_exception(e)
            return
        dt = time.monotonic() - t0
        for p, dst, src, n in took:
            p.results[src : src + n] = preds[dst : dst + n]
            if p.done == p.tiles.shape[0] and not p.future.done():
                p.future.set_result(p.results)
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["padded_rows"] += size - filled
            self._stats["capacity_rows"] += size
            self._stats["device_seconds"] += dt
