"""ctypes binding for the native C++ tile decoder (port of
crosstalk_tpu/data/native_loader.py).

``native/tile_loader.cpp`` is built with g++ at first use, from this
checkout's source only, into ``<checkout>/.cache/crosstalk_tpu_torch/native/``
(``ops/_build.build_native``: named by a sha256 of the source, the flags and
the host CPU's instruction-set flags, written through a temporary file and
``os.replace``). The port never loads the JAX package's cached library.

:func:`load_pairs_native` returns False when it cannot serve a request (no
compiler, an exotic TIFF flavour, a bad path, a shape mismatch); the caller
(``data/pipeline.load_tiles``) then decodes with the Python decoder and
counts the pairs it did so (``load_tiles.decoded``), so a broken build shows.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from crosstalk_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
# the first build-or-load: {"built": whether g++ ran, "seconds", "path",
# "error": why it failed or None}; empty until then
_status: Dict = {}
_lock = threading.Lock()  # one build, even when decode threads race to it


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _status:
            return _lib
        t0 = time.perf_counter()
        try:
            path = _build.native_library("tile_loader")
            built = not path.exists()
            lib = _build.load_native("tile_loader")
        except (RuntimeError, OSError) as e:
            _status.update(built=False, path=None, error=f"{type(e).__name__}: {e}",
                           seconds=time.perf_counter() - t0)
            return None
        _status.update(built=built, path=str(path), error=None,
                       seconds=time.perf_counter() - t0)
        lib.crosstalk_load_pairs.restype = ctypes.c_int
        lib.crosstalk_load_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the decoder is built and loaded (building it if needed)."""
    return _build_and_load() is not None


def build_status() -> Dict:
    """The first build-or-load of this process (building it if needed):
    ``{"built": whether g++ ran, "seconds": its wall, "path": the library,
    "error": why it failed, or None}``."""
    _build_and_load()
    return dict(_status)


def load_pairs_native(
    mixed_paths: Sequence[str],
    source_paths: Sequence[str],
    out: np.ndarray,
    threads: int = 8,
) -> bool:
    """Decode paired tiles into ``out`` (N, H, W, 2) float32 C-contiguous.
    Returns False (without touching semantics) when the native path can't
    serve this request — the caller falls back to Python."""
    lib = _build_and_load()
    if lib is None:
        return False
    n = len(mixed_paths)
    if out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        return False
    if out.shape[0] != n or out.ndim != 4 or out.shape[-1] != 2:
        return False
    height, width = int(out.shape[1]), int(out.shape[2])

    interleaved = []
    for m, s in zip(mixed_paths, source_paths):
        interleaved.append(m.encode())
        interleaved.append(s.encode())
    arr = (ctypes.c_char_p * (2 * n))(*interleaved)
    failed = ctypes.c_int64(-1)
    rc = lib.crosstalk_load_pairs(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height,
        width,
        threads,
        ctypes.byref(failed),
    )
    return rc == 0
