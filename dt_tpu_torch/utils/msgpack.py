"""A pure-Python msgpack codec for the JAX package's checkpoint format.

``dt_tpu`` writes checkpoints as msgpack with extension types for arrays;
the port reads and writes them without the ``msgpack`` package.
:func:`restore` decodes as the JAX package's own reader decodes, with arrays
as numpy except bfloat16, which numpy lacks: those come back as
``torch.bfloat16`` tensors (the buffer read as uint16 and viewed).
:func:`pack` encodes as the JAX package's writer encodes (the ``msgpack``
package's formats, doubles for floats, string keys sorted as a JAX pytree
sorts them), byte for byte, so its reader restores them.

The extension types: code 1 is an ndarray, packed as ``(shape,
dtype_name, buffer)``; code 3 a numpy scalar, packed the same way; code 2 a
complex, packed as ``(real, imag)``.  Any other code raises, and so does a
``__msgpack_chunked_array__`` dict (the writer's split of an array over 1
GiB); :func:`pack` writes arrays whole at any size.
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


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack(">B", n))
    elif -32 <= n < 0:
        out.append(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0x100), (0xcd, ">H", 0x10000),
                               (0xce, ">I", 0x100000000),
                               (0xcf, ">Q", 0x10000000000000000)):
            if n < top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length header: ``fix | n`` up to ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (``None`` where a form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0x100, 0x10000, 0x100000000)):
        if code is not None and n < top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} does not fit 32 bits")


def _ndarray_bytes(arr) -> bytes:
    """The ext payload of an array: ``(shape, dtype_name, buffer)``."""
    import torch
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return pack([list(t.shape), "bfloat16",
                         t.view(torch.int16).numpy().tobytes()])
        arr = t.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject:
        raise MsgpackError(f"cannot pack an array of {arr.dtype}")
    return pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: list) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(struct.pack(">Bb", fixed[len(data)], code))
    else:
        _pack_len(len(data), None, 0, (0xc7, 0xc8, 0xc9), out)
        out.append(struct.pack(">b", code))
    out.append(data)


def _encode(obj: Any, out: list) -> None:
    import torch
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(obj, out)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xdc, 0xdd), out)
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xde, 0xdf), out)
        keys = list(obj)
        if all(isinstance(k, str) for k in keys):
            keys.sort()  # the JAX writer's pytree pass sorts string keys
        for k in keys:
            _encode(k, out)
            _encode(obj[k], out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        _pack_ext(_EXT_COMPLEX, pack([obj.real, obj.imag]), out)
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def pack(obj: Any) -> bytes:
    """Encode ``obj`` (dicts, lists, str, bytes, numbers, None, numpy
    arrays and scalars, torch tensors, bfloat16 ones included) as the JAX
    package's checkpoint writer encodes it."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)
