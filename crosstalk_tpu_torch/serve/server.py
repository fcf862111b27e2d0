"""HTTP inference server (the port's copy of crosstalk_tpu/serve/server.py;
stdlib and numpy only).

Endpoints:
  POST /predict  — body: an ``.npz`` archive (``np.savez``) with either
                   ``tiles`` of shape (n, H, W, 2) float-like, or paired
                   ``mixed`` + ``source`` arrays of shape (n, H, W).
                   Response: ``{"alpha": [...], "n": n}``. Tiles are
                   min-max normalized on device (reference semantics,
                   train_model.py:211-216) — send raw intensities.
  GET  /healthz  — liveness + model identity.
  GET  /stats    — batching/throughput counters (see batcher.stats()).
  GET  /metrics  — the same counters in Prometheus text exposition format
                   (scrape-ready; counter/gauge types annotated).
  POST /reload   — ``{"model_path": ...}``: checkpoint hot-swap, when the
                   server was built with a ``reload_fn``.

The handler threads only parse bytes and wait on a Future; all device work
happens on the batcher's single dispatcher thread at a fixed set of
batch shapes (one by default; ``bucket_sizes`` adds smaller warmed-up
shapes for light-traffic latency). ``ThreadingHTTPServer`` gives one
thread per connection, which is plenty — request handling is IO-bound.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from crosstalk_tpu_torch.serve.batcher import DynamicBatcher
from crosstalk_tpu_torch.serve.wire import to_f16_wire

# Default request-body cap: 256 MiB holds ~1,000 256x256 float16 pairs
# (or ~500 float32 ones) — far above any sane request, far below a level
# that lets a handful of concurrent posts exhaust host memory. Both caps
# are constructor/CLI-configurable (``max_body_bytes`` / ``max_tiles``).
_MAX_BODY = 256 << 20
_MAX_TILES = 4096  # decoded-tile cap per request (post-decompression bound)


def _check_decoded_size(body: bytes, tile_hw, max_tiles: int) -> None:
    """Reject zip-bombs BEFORE np.load materializes anything.

    An npz is a zip of .npy members; deflate compresses constant arrays
    ~1000x, so a 4 MB body under the Content-Length cap can decode to
    4+ GB. Each member's shape/dtype sits in its .npy header — read just
    the headers and bound the element count by what ``max_tiles`` already
    permits (the operator's memory knob), without decompressing the data.
    """
    import zipfile

    max_elements = int(max_tiles) * tile_hw[0] * tile_hw[1] * 2
    # byte budget: the element cap at float64 width (the widest sane
    # payload). Bounding BYTES, not elements, closes the wide-dtype bypass:
    # a tiny compressed member declaring e.g. a ('V1048576',) structured
    # dtype would pass an element-count check yet decode to gigabytes.
    max_bytes = max_elements * 8
    try:
        with zipfile.ZipFile(io.BytesIO(body)) as zf:
            names = zf.namelist()
            if len(names) > 8:
                raise ValueError(f"npz holds {len(names)} members, cap is 8")
            for name in names:
                with zf.open(name) as fp:
                    version = np.lib.format.read_magic(fp)
                    if version == (1, 0):
                        shape, _, dt = np.lib.format.read_array_header_1_0(fp)
                    elif version == (2, 0):
                        shape, _, dt = np.lib.format.read_array_header_2_0(fp)
                    else:
                        raise ValueError(
                            f"unsupported .npy format version {version}"
                        )
                if dt.hasobject:
                    raise ValueError(f"member {name!r} has object dtype")
                elements = 1
                for dim in shape:
                    elements *= int(dim)
                if elements > max_elements:
                    raise ValueError(
                        f"member {name!r} would decode to {shape} "
                        f"({elements:,} elements); the request cap is "
                        f"{max_tiles} tiles ({max_elements:,} elements)"
                    )
                if elements * dt.itemsize > max_bytes:
                    raise ValueError(
                        f"member {name!r} ({shape}, dtype {dt}) would decode "
                        f"to {elements * dt.itemsize:,} bytes; the request "
                        f"cap is {max_bytes:,}"
                    )
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"body is not a readable .npz archive: {e}")


def _decode_request(
    body: bytes, tile_hw, max_tiles: int, transport_dtype=np.float32
) -> np.ndarray:
    """npz bytes -> (n, H, W, 2) ``transport_dtype`` tiles. Raises ValueError.

    Accepts any numeric payload dtype (float16 halves the wire size and is
    the recommended production format — see client.predict(dtype=...)).
    The result is cast ONCE, straight to the batcher's transport dtype (an
    f16 payload on an f16-transport server passes through copy-free; the
    old decode-to-f32-then-recast allocated a throwaway f32 copy of every
    request on the hot path). Downcasting a wider payload to f16 rescales
    per (tile, channel) first (serve/wire.py) — a direct cast would
    overflow raw counts above 65504.
    """
    transport_dtype = np.dtype(transport_dtype)
    _check_decoded_size(body, tile_hw, max_tiles)
    try:
        with np.load(io.BytesIO(body)) as npz:
            if "tiles" in npz:
                tiles = npz["tiles"]
            elif "mixed" in npz and "source" in npz:
                mixed, source = npz["mixed"], npz["source"]
                if mixed.shape != source.shape:
                    raise ValueError(
                        f"mixed {mixed.shape} and source {source.shape} "
                        "shapes differ"
                    )
                if mixed.ndim == 2:
                    mixed, source = mixed[None], source[None]
                tiles = np.stack([mixed, source], axis=-1)
            else:
                raise ValueError(
                    "npz must contain 'tiles' (n, H, W, 2) or "
                    "'mixed' + 'source' (n, H, W)"
                )
            if tiles.dtype.kind not in "fiu":
                raise ValueError(f"tiles dtype {tiles.dtype} is not numeric")
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"body is not a readable .npz archive: {e}")
    if tiles.ndim == 3 and tiles.shape[-1] == 2:
        tiles = tiles[None]
    if tiles.ndim != 4 or tiles.shape[-1] != 2:
        raise ValueError(f"expected (n, H, W, 2) tiles, got {tiles.shape}")
    if tiles.shape[1:3] != tuple(tile_hw):
        raise ValueError(
            f"model serves {tile_hw[0]}x{tile_hw[1]} tiles, got "
            f"{tiles.shape[1]}x{tiles.shape[2]}"
        )
    if tiles.shape[0] > max_tiles:
        raise ValueError(
            f"request holds {tiles.shape[0]} tiles, cap is {max_tiles}; "
            "split into smaller requests"
        )
    def _reject_non_finite(arr):
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise ValueError(
                "tiles contain non-finite values (inf/NaN); the per-tile "
                "min-max normalize would propagate them into every "
                "prediction of the tile"
            )

    if tiles.dtype == transport_dtype:
        _reject_non_finite(tiles)
        return tiles
    if transport_dtype == np.float16:
        # EVERY non-f16 payload goes through the rescale-then-cast wire
        # transform — a direct cast would overflow raw integer counts
        # (uint16 65535 -> inf -> NaN predictions with HTTP 200) and
        # coarsely quantize anything above 2048
        _reject_non_finite(tiles)
        return to_f16_wire(tiles, (1, 2))
    with np.errstate(over="ignore"):  # overflow is detected, not a warning
        out = np.asarray(tiles, transport_dtype)
    if out.dtype.kind == "f" and not np.isfinite(out).all():
        # one post-cast scan covers the converting path: NaN/inf in the
        # payload survive a float->float cast and integers are always
        # finite, so a pre-cast scan would be redundant O(n) work per
        # request. Only on failure (cold path) re-scan the input to tell
        # payload NaN/inf apart from cast overflow.
        _reject_non_finite(tiles)
        # e.g. float64 values beyond float32 range: finite before the
        # cast, inf after it — reject like any other non-finite payload
        raise ValueError(
            "tiles overflow the server transport dtype "
            f"({np.dtype(transport_dtype).name}); rescale the payload or "
            "send smaller magnitudes"
        )
    return out


class _Handler(BaseHTTPRequestHandler):
    # set on the server instance: batcher, model_info, tile_hw
    protocol_version = "HTTP/1.1"

    def setup(self):
        # Socket read timeout: without it, a client that sends headers but
        # never the body (or an idle keep-alive connection) pins one handler
        # thread forever — a trivial slow-loris DoS on ThreadingHTTPServer.
        # BaseHTTPRequestHandler treats a timed-out request line as
        # end-of-connection; mid-body timeouts get a 408 in do_POST.
        self.timeout = self.server.io_timeout
        super().setup()

    def _send_json(self, code: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code >= 400:
            # error paths may not have drained the request body; on a
            # keep-alive (HTTP/1.1) connection the unread bytes would be
            # parsed as the next request line — close instead
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib casing)
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok", **self.server.model_info})
        elif self.path == "/stats":
            self._send_json(200, self.server.batcher.stats())
        elif self.path == "/metrics":
            self._send_metrics()
        else:
            self._send_json(404, {"error": f"no such endpoint: {self.path}"})

    def _send_metrics(self) -> None:
        """Prometheus text exposition of the batcher counters."""
        s = self.server.batcher.stats()
        rows = [
            ("requests_total", "counter", s["requests"],
             "Prediction requests received"),
            ("tiles_total", "counter", s["tiles"],
             "Tiles received across all requests"),
            ("batches_total", "counter", s["batches"],
             "Device batches dispatched"),
            ("padded_rows_total", "counter", s["padded_rows"],
             "Zero-padded rows across dispatched batches"),
            ("batch_capacity_rows_total", "counter", s["capacity_rows"],
             "Total rows of dispatched batch capacity"),
            ("device_seconds_total", "counter", s["device_seconds"],
             "Wall seconds spent in predict_fn calls"),
            ("model_reloads_total", "counter", s["reloads"],
             "Checkpoint hot-swaps performed"),
            ("batch_occupancy", "gauge",
             s.get("mean_batch_occupancy", 1.0),
             "1 - padded/capacity over all dispatched batches"),
            ("batch_size", "gauge", s["batch_size"],
             "Largest (default) device batch shape"),
        ]
        lines = []
        for name, mtype, value, help_text in rows:
            full = f"crosstalk_{name}"
            lines.append(f"# HELP {full} {help_text}")
            lines.append(f"# TYPE {full} {mtype}")
            lines.append(f"{full} {value}")
        for size in s.get("bucket_sizes", []):
            lines.append(
                f'crosstalk_batch_bucket{{size="{size}"}} 1'
            )
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        if self.path == "/reload":
            self._do_reload()
            return
        if self.path != "/predict":
            self._send_json(404, {"error": f"no such endpoint: {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._send_json(
                400,
                {"error": "bad Content-Length: "
                          f"{self.headers.get('Content-Length')!r}"},
            )
            return
        if length <= 0 or length > self.server.max_body_bytes:
            self._send_json(400, {"error": f"bad Content-Length: {length}"})
            return
        try:
            body = self.rfile.read(length)
        except TimeoutError:
            self._send_json(
                408,
                {"error": "timed out reading the request body "
                          f"({self.server.io_timeout}s)"},
            )
            return
        try:
            tiles = _decode_request(
                body, self.server.tile_hw, self.server.max_tiles,
                self.server.transport_dtype,
            )
            alphas = self.server.batcher.submit(tiles).result(
                timeout=self.server.request_timeout
            )
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send_json(
            200, {"alpha": [float(a) for a in alphas], "n": int(len(alphas))}
        )

    def _do_reload(self):
        """POST /reload {"model_path": "..."} — zero-downtime checkpoint
        hot-swap. Disabled unless the server was built with a reload_fn
        (the CLI's --allow_reload); requests keep serving on the old model
        while the new one loads and warms up."""
        if self.server.reload_fn is None:
            self._send_json(
                403, {"error": "reload is disabled (start the server with "
                               "--allow_reload to enable it)"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = -1
        if not 0 < length <= (1 << 20):  # a path payload, not a tile payload
            self._send_json(400, {"error": f"bad Content-Length: {length}"})
            return
        try:
            req = json.loads(self.rfile.read(length))
            path = req["model_path"]
        except TimeoutError:
            self._send_json(
                408, {"error": "timed out reading the request body"})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(
                400, {"error": "body must be JSON with a 'model_path' key: "
                               f"{type(e).__name__}: {e}"})
            return
        try:
            # one reload at a time; load+warmup happens INSIDE reload_fn,
            # before the swap, so serving never pauses
            with self.server.reload_lock:
                predict_fn, info = self.server.reload_fn(path)
                self.server.batcher.swap_predict_fn(predict_fn)
                self.server.model_info = dict(info)
        except (FileNotFoundError, KeyError, ValueError) as e:
            self._send_json(
                400, {"error": f"reload failed ({type(e).__name__}: {e}); "
                               "still serving the previous model"})
            return
        except Exception as e:
            self._send_json(
                500, {"error": f"reload failed ({type(e).__name__}: {e}); "
                               "still serving the previous model"})
            return
        self._send_json(200, {"status": "reloaded", **self.server.model_info})

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)


class CrosstalkServer:
    """Own the HTTP listener + batcher; serve until ``shutdown()``."""

    def __init__(
        self,
        predict_fn,
        batch_size: int,
        image_size: int = 256,
        host: str = "127.0.0.1",
        port: int = 0,
        max_delay_ms: float = 5.0,
        model_info: Optional[Dict] = None,
        request_timeout: float = 120.0,
        verbose: bool = False,
        max_body_bytes: int = _MAX_BODY,
        max_tiles: int = _MAX_TILES,
        transport_dtype="float32",
        reload_fn=None,
        bucket_sizes=None,
        io_timeout: float = 60.0,
    ):
        # ``reload_fn(model_path) -> (predict_fn, model_info)`` enables the
        # POST /reload endpoint (zero-downtime checkpoint hot-swap). Loading
        # a .pth unpickles it — only enable on trusted/admin networks.
        # transport_dtype='float16' assembles device batches in f16 —
        # half the host->device bytes; the predictor must be built with
        # input_dtype=np.float16 so the upcast happens on device.
        self.batcher = DynamicBatcher(
            predict_fn,
            batch_size,
            tile_shape=(image_size, image_size, 2),
            max_delay_ms=max_delay_ms,
            dtype=transport_dtype,
            bucket_sizes=bucket_sizes,
        )
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.batcher = self.batcher
        self._httpd.tile_hw = (image_size, image_size)
        self._httpd.model_info = model_info or {}
        self._httpd.request_timeout = request_timeout
        self._httpd.verbose = verbose
        self._httpd.max_body_bytes = int(max_body_bytes)
        self._httpd.max_tiles = int(max_tiles)
        self._httpd.transport_dtype = np.dtype(transport_dtype)
        self._httpd.reload_fn = reload_fn
        self._httpd.reload_lock = threading.Lock()
        # per-connection socket read timeout (slow-loris guard); None disables
        self._httpd.io_timeout = io_timeout
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound (port resolved when 0 was passed)."""
        return self._httpd.server_address

    def serve_forever(self) -> None:
        self._started = True
        self._httpd.serve_forever()

    def start_background(self) -> None:
        self._started = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="crosstalk-http", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        # BaseServer.shutdown() waits on an event that only a running
        # serve_forever() loop ever sets — calling it on a constructed but
        # never-started server (e.g. from a cleanup block after a failed
        # setup step) would block forever
        if getattr(self, "_started", False):
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.batcher.close()
