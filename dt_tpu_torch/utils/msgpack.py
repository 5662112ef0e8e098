"""A pure-Python msgpack decoder for the JAX package's checkpoint format.

``dt_tpu`` writes checkpoints as msgpack with extension types for arrays;
the port reads them without the ``msgpack`` package.  Decoded as the JAX
package's own reader decodes them, with arrays as numpy except bfloat16,
which numpy lacks: those come back as ``torch.bfloat16`` tensors (the buffer
read as uint16 and viewed).

The extension types: code 1 is an ndarray, packed as ``(shape,
dtype_name, buffer)``; code 3 a numpy scalar, packed the same way; code 2 a
complex, packed as ``(real, imag)``.  Any other code raises, and so does a
``__msgpack_chunked_array__`` dict (the writer's split of an array over 1 GiB).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class MsgpackError(ValueError):
    """The bytes are not msgpack this decoder takes."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: need {n} bytes at offset "
                               f"{self.pos}, have {len(self.data) - self.pos}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width headers: byte -> struct format of the length or value
_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_INT = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f)
    if b == 0xc0:
        return None
    if b == 0xc2:
        return False
    if b == 0xc3:
        return True
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    if b in _UINT:
        return r.unpack(_UINT[b])
    if b in _INT:
        return r.unpack(_INT[b])
    if b in _BIN:
        return bytes(r.take(r.unpack(_BIN[b])))
    if b in _STR:
        return _str(r, r.unpack(_STR[b]))
    if b in _ARRAY:
        return [_decode(r) for _ in range(r.unpack(_ARRAY[b]))]
    if b in _MAP:
        return _map(r, r.unpack(_MAP[b]))
    if b in _FIXEXT:
        return _ext(r.unpack(">b"), r.take(_FIXEXT[b]))
    if b in _EXT:
        n = r.unpack(_EXT[b])
        return _ext(r.unpack(">b"), r.take(n))
    raise MsgpackError(f"unknown msgpack type byte 0x{b:02x} at offset "
                       f"{r.pos - 1}")


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    if "__msgpack_chunked_array__" in out:
        raise MsgpackError("chunked arrays (the writer's split of arrays "
                           "over 1 GiB) are not supported")
    return out


def _ndarray(data: memoryview):
    shape, dtype_name, buf = restore(bytes(data))
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        import torch
        flat = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    if code == _EXT_COMPLEX:
        real, imag = restore(bytes(data))
        return complex(real, imag)
    raise MsgpackError(f"unknown msgpack ext code {code}")


def restore(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``, as the JAX package's
    checkpoint reader decodes it."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes after the "
                           "object")
    return out
