"""Python client for the crosstalk inference server (serve/server.py; the
port's copy of crosstalk_tpu/serve/client.py, which speaks the same wire
format to either package's server).

Stdlib-only (urllib + numpy): the same wire format the server speaks —
npz request bodies, JSON responses. Intended both as the convenient
programmatic surface and as executable documentation of the protocol.

    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    client = CrosstalkClient("http://127.0.0.1:8000")
    alphas = client.predict(mixed, source)      # (n, H, W) arrays -> (n,)
"""

from __future__ import annotations

import io
import json
import urllib.request
from typing import Dict, Optional

import numpy as np

from crosstalk_tpu_torch.serve.wire import to_f16_wire


class CrosstalkClient:
    def __init__(self, url: str, timeout: float = 120.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _get_json(self, path: str) -> Dict:
        with urllib.request.urlopen(self.url + path, timeout=self.timeout) as r:
            return json.load(r)

    def health(self) -> Dict:
        return self._get_json("/healthz")

    def stats(self) -> Dict:
        return self._get_json("/stats")

    def predict(
        self,
        mixed: np.ndarray,
        source: Optional[np.ndarray] = None,
        dtype: Optional[str] = None,
        chunk: Optional[int] = None,
    ) -> np.ndarray:
        """Predict alphas. Either ``mixed`` + ``source`` of shape (n, H, W)
        (or a single (H, W) tile each), or ``mixed`` alone already stacked
        as (n, H, W, 2). Returns (n,) float32.

        ``dtype`` casts the payload before upload; ``"float16"`` halves the
        wire size (the recommended production format on bandwidth-limited
        links, where the upload dominates). f16 payloads are first rescaled
        per (tile, channel) to [0, 1] (serve/wire.py) — the server's
        on-device min-max normalize is exactly invariant under that, and a
        direct cast would overflow raw counts above 65504 (a saturated
        16-bit pixel) into inf/NaN predictions. Net perturbation is the f16
        quantization of normalized values, ~1e-3 on alpha. Omit (None)
        to send the arrays' own dtype, e.g. for f32 parity checks.

        ``chunk`` splits a large request into sequential posts of at most
        that many tiles (the server rejects requests above its
        ``--max_tiles`` / ``--max_body_mb`` caps; chunking at e.g. the
        server's batch size stays under both and bounds per-post memory).
        Results concatenate in order, so the caller sees one (n,) array.
        """
        if dtype is not None and np.dtype(dtype) == np.float16:
            # spatial axes: all but a leading batch dim / trailing channel dim
            def cast(a, channels):
                a = np.asarray(a)
                nd = a.ndim - (1 if channels else 0)
                axes = (0, 1) if nd == 2 else (1, 2)
                return to_f16_wire(a, axes)
        elif dtype is not None:
            def cast(a, channels):
                return np.asarray(a, dtype)
        else:
            def cast(a, channels):
                return np.asarray(a)
        if source is None:
            arrays = {"tiles": cast(mixed, True)}
            n = 1 if arrays["tiles"].ndim == 3 else arrays["tiles"].shape[0]
        else:
            arrays = {"mixed": cast(mixed, False), "source": cast(source, False)}
            n = 1 if arrays["mixed"].ndim == 2 else arrays["mixed"].shape[0]
        if chunk is not None and chunk > 0 and n > chunk:
            parts = [
                self._post_predict(
                    {k: v[lo : lo + chunk] for k, v in arrays.items()}
                )
                for lo in range(0, n, chunk)
            ]
            return np.concatenate(parts)
        return self._post_predict(arrays)

    def _post_predict(self, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(self.url + "/predict", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.load(r)
        return np.asarray(out["alpha"], np.float32)

    def reload(self, model_path: str) -> Dict:
        """Hot-swap the served checkpoint (server must run --allow_reload).

        Requests issued during the reload keep being served by the previous
        model; the swap happens only after the new one has loaded and
        warmed up. Returns the server's new model info."""
        body = json.dumps({"model_path": model_path}).encode()
        req = urllib.request.Request(self.url + "/reload", data=body)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.load(r)
