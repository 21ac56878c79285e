"""A pure-Python msgpack codec for flax's checkpoint files.

flax writes ``params.msgpack`` with ``flax.serialization.to_bytes``:
``msgpack.packb(state_dict, default=..., strict_types=True)`` of nested
dicts with string keys. This module reads and writes that subset without
the ``msgpack`` package, byte for byte as flax does:

- nil, bool, int, float (64-bit; 32-bit is read), str, bin, array and map;
- ext 1, an ndarray: the packed triple ``(shape, dtype.name, C-order
  bytes)``;
- ext 3, a numpy scalar: the same triple of a 0-d array;
- ext 2, a complex number, and other ext codes are refused with an error.

Arrays come back read-only over the file's bytes, as flax returns them
(a ``bfloat16`` array loads where numpy knows that dtype, through
``ml_dtypes``, and raises elsewhere). flax splits a leaf of
1 GiB or more into a ``__msgpack_chunked_array__`` dict; reading or writing
one raises ``NotImplementedError`` (a ConvNP has none).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2**30  # flax's leaf size from which it chunks


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """The smallest of a fix form (``fix | n`` for n <= fix_max, fix None:
    none) and the 8/16/32-bit length forms ``codes`` (None: absent)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("integer out of msgpack's range")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    out = bytearray()
    _pack(out, (a.shape, a.dtype.name, a.tobytes("C")))
    return bytes(out)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)
    out += data


def _pack(out: bytearray, obj: Any) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out += b
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t in (list, tuple):
        _header(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _header(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise NotImplementedError("leaves of 1 GiB or more (flax's chunked arrays)")
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialise {t.__name__} in a flax checkpoint")


def packb(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts (keys as ``str``),
    lists, Python scalars and numpy arrays/scalars."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# type byte → struct format of its length (bin, ext, str, array, map) or of
# its value (float, uint, int)
_LENGTHS = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xC7: "B", 0xC8: ">H", 0xC9: ">I",
            0xD9: "B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise NotImplementedError("flax's chunked arrays (leaves of 1 GiB or more)")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code == EXT_COMPLEX:
            raise ValueError("complex numbers (msgpack ext 2) are not supported in "
                             "ConvNP checkpoints")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext code {code}")
        shape, name, buf = unpackb(data)
        a = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")
        return a[()] if code == EXT_NPSCALAR else a


def unpackb(data: bytes):
    """``flax.serialization.msgpack_restore`` of ``data``."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out
