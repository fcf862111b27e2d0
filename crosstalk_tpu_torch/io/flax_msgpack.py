"""A reader for flax's msgpack state bytes, with neither ``msgpack`` nor
``flax``.

The JAX package writes its train state with ``flax.serialization.to_bytes``
(crosstalk_tpu/io/checkpoint.py): a msgpack map of the state dict whose
array leaves are msgpack ext objects. ``msgpack_restore`` decodes such bytes
as ``flax.serialization.msgpack_restore`` does:

  * msgpack maps, arrays, str, bin, nil, bool, ints and floats of every
    width, and ext objects;
  * flax's ext codes: 1 = ndarray and 3 = numpy scalar, each a packed
    ``(shape, dtype name, C-order bytes)``; 2 = complex, a packed
    ``(real, imag)``; any other code raises ValueError;
  * flax's chunked arrays (a dict with ``__msgpack_chunked_array__``, which
    flax writes for leaves above ``MAX_CHUNK_SIZE = 2**30`` bytes),
    reassembled.

Array leaves are ``np.frombuffer`` views over the input buffer where their
offset is aligned to their item size, and copies where it is not: a
two-branch train state is ~1.6 GB, read once. A ``bfloat16`` leaf (numpy has
no such dtype without ``ml_dtypes``) becomes a ``torch.bfloat16`` tensor
viewing its ``uint16`` bytes; every other leaf is a numpy array or scalar.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# first byte -> (struct format of the fixed-width value, its size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# first byte -> size of the length field (str, bin, array, map, ext)
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """Decodes one msgpack object at a time from ``buf[pos:end]``. bin
    values come back as ``(offset, length)`` spans of ``buf`` so that array
    payloads are never copied."""

    def __init__(self, buf, pos: int = 0, end: int = None):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = pos
        self.end = len(self.view) if end is None else end

    def _take(self, n: int) -> int:
        start = self.pos
        if n < 0 or start + n > self.end:
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at "
                             f"offset {start}, {self.end - start} left")
        self.pos = start + n
        return start

    def _unpack(self, fmt: str, size: int):
        return struct.unpack_from(fmt, self.view, self._take(size))[0]

    def _length(self, width: int) -> int:
        return self._unpack(_UINT[width], width)

    def _str(self, n: int) -> str:
        start = self._take(n)
        return bytes(self.view[start:start + n]).decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b", 1)
        start = self._take(n)
        return _decode_ext(code, self.buf, start, start + n)

    def read(self) -> Any:
        b = self._unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self._unpack(*_FIXED[b])
        if b in _STR:
            return self._str(self._length(_STR[b]))
        if b in _BIN:
            n = self._length(_BIN[b])
            return _Span(self._take(n), n)
        if b in _ARRAY:
            return [self.read() for _ in range(self._length(_ARRAY[b]))]
        if b in _MAP:
            return self._map(self._length(_MAP[b]))
        if b in _EXT:
            return self._ext(self._length(_EXT[b]))
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        raise ValueError(f"not msgpack data: byte 0x{b:02x} at offset {self.pos - 1}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


class _Span(tuple):
    """A bin value: (offset, length) in the reader's buffer."""

    def __new__(cls, offset: int, length: int):
        return super().__new__(cls, (offset, length))


def _array(buf, start: int, end: int):
    """An ext-1/ext-3 payload ``(shape, dtype name, bytes)`` -> array."""
    fields = _Reader(buf, start, end).read()
    if not (isinstance(fields, list) and len(fields) == 3
            and isinstance(fields[2], _Span)):
        raise ValueError("malformed flax ndarray payload")
    shape, name, (offset, nbytes) = fields
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(s) for s in shape)
    count = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        dtype = np.dtype(np.uint16)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"flax array of dtype {name!r}: not readable without "
                             "ml_dtypes") from None
    if count * dtype.itemsize != nbytes:
        raise ValueError(f"flax array {shape} {name}: {nbytes} bytes, expected "
                         f"{count * dtype.itemsize}")
    if count == 0:
        arr = np.empty(shape, dtype)
    else:
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=offset).reshape(shape)
        if not arr.flags.aligned:
            arr = arr.copy()
    if name == "bfloat16":
        # torch warns on a read-only numpy array; such a buffer is copied
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).view(
            torch.bfloat16)
    return arr


def _decode_ext(code: int, buf, start: int, end: int):
    if code == EXT_NDARRAY:
        return _array(buf, start, end)
    if code == EXT_NPSCALAR:
        arr = _array(buf, start, end)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        parts = _Reader(buf, start, end).read()
        if not (isinstance(parts, list) and len(parts) == 2):
            raise ValueError("malformed flax complex payload")
        return complex(parts[0], parts[1])
    raise ValueError(f"msgpack ext code {code} is not one of flax's "
                     f"(ndarray {EXT_NDARRAY}, complex {EXT_COMPLEX}, "
                     f"numpy scalar {EXT_NPSCALAR})")


def _unchunk(d: dict):
    n = len(d["chunks"])
    chunks = [d["chunks"][str(i)] for i in range(n)]
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    if all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _finish(node, buf):
    """Turn bin spans into bytes and chunked-array dicts into arrays."""
    if isinstance(node, _Span):
        start, n = node
        return bytes(memoryview(buf)[start:start + n])
    if isinstance(node, dict):
        out = {k: _finish(v, buf) for k, v in node.items()}
        return _unchunk(out) if out.get(CHUNKED) is True else out
    if isinstance(node, list):
        return [_finish(v, buf) for v in node]
    return node


def msgpack_restore(data) -> Any:
    """flax msgpack bytes (``bytes``, ``bytearray`` or ``memoryview``) -> the
    state dict: nested dicts and lists with numpy (bf16: torch) leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != reader.end:
        raise ValueError(f"{reader.end - reader.pos} trailing bytes after the "
                         "msgpack object")
    return _finish(tree, data)

