"""Self-contained ONNX export and import for the port (counterpart of
``dt_tpu/onnx.py``); no ``onnx`` package is needed.

The protobuf codec (varints, tags, tensors, attributes, nodes, value infos,
the model) is the JAX package's, byte for byte: the file format is the
contract between the two packages, so a file either package writes, the
other reads.

:func:`export_onnx` walks the ATen graph that ``torch.export`` traces from a
CPU copy of a port model (``run_decompositions()``: convolution, pooling,
matrix products, elementwise, reshapes, reductions) and emits only ops that
the JAX package's importer reads.  Its interface is the JAX export's: the
graph input is NHWC (the exporter puts the port's ``permute(0, 3, 1, 2)``
in front of an image model), shapes are baked at the example's batch, and
the weights become initializers.  An ATen op with no mapping raises
``NotImplementedError`` naming it.

:func:`import_onnx` returns ``(fn, params)``; ``fn(params, *inputs)`` runs
the node list with torch ops on the inputs' device, the same op set as the
JAX importer with JAX's semantics (its type promotion, explicit asymmetric
pads, ``count_include_pad``).  ``Predictor.from_onnx`` serves a file with it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ----------------------------------------------------------------------
# protobuf wire-format primitives
# ----------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _str_field(field: int, value: str) -> bytes:
    return _len_delim(field, value.encode())


class _Reader:
    """Minimal protobuf reader: iterate (field, wire, value) triplets."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _read_varint(self) -> int:
        shift = 0
        out = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def __iter__(self):
        while self.pos < len(self.buf):
            key = self._read_varint()
            field, wire = key >> 3, key & 7
            if wire == 0:
                yield field, self._read_varint()
            elif wire == 2:
                n = self._read_varint()
                yield field, self.buf[self.pos:self.pos + n]
                self.pos += n
            elif wire == 5:
                yield field, self.buf[self.pos:self.pos + 4]
                self.pos += 4
            elif wire == 1:
                yield field, self.buf[self.pos:self.pos + 8]
                self.pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")


def _signed(v: int) -> int:
    """Decode a varint as int64 two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------------
# ONNX schema subset (public field numbers from onnx.proto)
# ----------------------------------------------------------------------

# TensorProto.DataType
_DT_FLOAT, _DT_UINT8, _DT_INT8, _DT_INT32, _DT_INT64 = 1, 2, 3, 6, 7
_DT_BOOL, _DT_FLOAT16, _DT_DOUBLE, _DT_BF16 = 9, 10, 11, 16

_NP_TO_ONNX = {
    np.dtype(np.float32): _DT_FLOAT, np.dtype(np.uint8): _DT_UINT8,
    np.dtype(np.int8): _DT_INT8, np.dtype(np.int32): _DT_INT32,
    np.dtype(np.int64): _DT_INT64, np.dtype(np.bool_): _DT_BOOL,
    np.dtype(np.float16): _DT_FLOAT16, np.dtype(np.float64): _DT_DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    shape = np.shape(arr)  # before ascontiguousarray: it promotes 0-d
    # arrays to (1,), which would bake a phantom dim into the file
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_ONNX:
        arr = arr.astype(np.float32)
    out = b"".join(_int_field(1, d) for d in shape)
    out += _int_field(2, _NP_TO_ONNX[arr.dtype])
    out += _str_field(8, name)
    out += _len_delim(9, arr.tobytes())  # raw_data
    return out


def _unpack_varints(blob: bytes) -> List[int]:
    """Decode a packed-repeated varint blob (wire type 2).

    proto3 serializers (the official ``onnx`` package included) emit
    repeated scalar fields packed by default; our own emitter writes them
    unpacked.  Importers must accept both.
    """
    r = _Reader(blob)
    out: List[int] = []
    while r.pos < len(blob):
        out.append(_signed(r._read_varint()))
    return out


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = _DT_FLOAT
    name = ""
    raw = b""
    float_data: List[float] = []
    int_data: List[int] = []
    for field, val in _Reader(buf):
        if field == 1:  # dims: unpacked varints OR a packed varint blob
            if isinstance(val, bytes):
                dims.extend(_unpack_varints(val))
            else:
                dims.append(_signed(val))
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 4:  # packed float_data
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", val)) \
                if isinstance(val, bytes) else float_data.append(val)
        elif field in (5, 7):  # int32_data / int64_data (packed varints)
            if isinstance(val, bytes):
                int_data.extend(_unpack_varints(val))
            else:
                int_data.append(_signed(val))
    np_dt = _ONNX_TO_NP.get(dtype, np.dtype(np.float32))
    if raw:
        arr = np.frombuffer(raw, np_dt).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np_dt).reshape(dims)
    else:
        arr = np.asarray(int_data, np_dt).reshape(dims)
    return name, arr


# AttributeProto types
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8


def _attr(name: str, value) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _tag(3, 0) + _varint(int(value)) + _int_field(20, _AT_INT)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) \
            + _int_field(20, _AT_FLOAT)
    elif isinstance(value, str):
        out += _len_delim(4, value.encode()) + _int_field(20, _AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _len_delim(5, _tensor_proto(name + "_t", value)) \
            + _int_field(20, _AT_TENSOR)
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], (float, np.floating)):
        out += b"".join(_tag(7, 5) + struct.pack("<f", float(v))
                        for v in value)
        out += _int_field(20, _AT_FLOATS)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, (bool, int, np.integer)) for v in value):
        out += b"".join(_tag(8, 0) + _varint(int(v)) for v in value)
        out += _int_field(20, _AT_INTS)
    else:
        raise TypeError(
            f"attribute {name!r}: unsupported value {value!r} "
            f"({type(value).__name__})")
    return out


def _parse_attr(buf: bytes):
    name = ""
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    for field, val in _Reader(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            f = struct.unpack("<f", val)[0]
        elif field == 3:
            i = _signed(val)
        elif field == 4:
            s = val.decode()
        elif field == 5:
            t = _parse_tensor(val)[1]
        elif field == 7:  # floats: unpacked fixed32 OR packed blob
            if isinstance(val, bytes) and len(val) != 4:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:  # ints: unpacked varints OR packed blob
            if isinstance(val, bytes):
                ints.extend(_unpack_varints(val))
            else:
                ints.append(_signed(val))
    for v in (t, s):
        if v is not None:
            return name, v
    if ints:
        return name, ints
    if floats:
        return name, floats
    if i is not None:
        return name, i
    return name, f


def _node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", **attrs) -> bytes:
    out = b"".join(_str_field(1, x) for x in inputs)
    out += b"".join(_str_field(2, x) for x in outputs)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    out += b"".join(_len_delim(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _parse_node(buf: bytes) -> dict:
    node = {"input": [], "output": [], "op_type": "", "name": "",
            "attrs": {}}
    for field, val in _Reader(buf):
        if field == 1:
            node["input"].append(val.decode())
        elif field == 2:
            node["output"].append(val.decode())
        elif field == 3:
            node["name"] = val.decode()
        elif field == 4:
            node["op_type"] = val.decode()
        elif field == 5:
            k, v = _parse_attr(val)
            node["attrs"][k] = v
    return node


def _value_info(name: str, shape: Sequence[int], dtype) -> bytes:
    shape_proto = b"".join(
        _len_delim(1, _int_field(1, d)) for d in shape)
    tensor_type = _int_field(1, _NP_TO_ONNX.get(np.dtype(dtype), _DT_FLOAT))
    tensor_type += _len_delim(2, shape_proto)
    return _str_field(1, name) + _len_delim(2, _len_delim(1, tensor_type))


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple[int, ...], Any]:
    name = ""
    shape: List[int] = []
    dtype = np.float32
    for field, val in _Reader(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            for f2, v2 in _Reader(val):
                if f2 == 1:  # tensor_type
                    for f3, v3 in _Reader(v2):
                        if f3 == 1:
                            dtype = _ONNX_TO_NP.get(v3, np.dtype(np.float32))
                        elif f3 == 2:  # shape
                            for f4, v4 in _Reader(v3):
                                if f4 == 1:  # dim
                                    for f5, v5 in _Reader(v4):
                                        if f5 == 1:
                                            shape.append(_signed(v5))
    return name, tuple(shape), dtype


def _model_proto(graph: bytes, opset: int) -> bytes:
    out = _int_field(1, 8)  # ir_version 8
    out += _str_field(2, "dt_tpu")
    out += _len_delim(7, graph)
    out += _len_delim(8, _str_field(1, "") + _int_field(2, opset))
    return out



# ----------------------------------------------------------------------
# ATen graph -> ONNX graph
# ----------------------------------------------------------------------

_TORCH_TO_NP = {
    torch.float32: np.float32, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
    torch.float16: np.float16, torch.float64: np.float64,
    torch.bfloat16: np.float32,  # numpy has no bfloat16
}


class _Graph:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0
        self._const_cache: Dict[Any, str] = {}

    def name(self, hint="t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op: str, inputs: Sequence[str], n_out: int = 1,
            **attrs) -> List[str]:
        """Emit one node; ``n_out`` names that many outputs."""
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op, inputs, outs,
                                name=self.name(op), **attrs))
        return outs

    def const(self, arr: np.ndarray, hint="const") -> str:
        key = (arr.shape, str(arr.dtype), arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = self.name(hint)
        self.initializers.append(_tensor_proto(name, arr))
        self._const_cache[key] = name
        return name


def _meta(node):
    """The traced value of an fx node (a fake tensor, or a tuple of them)."""
    return node.meta.get("val")


def _np_dtype(node) -> np.dtype:
    return np.dtype(_TORCH_TO_NP.get(_meta(node).dtype, np.float32))


def _axis(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


class _Exporter:
    """Emit the ONNX nodes of one ``torch.export`` graph."""

    _UNARY = {"relu": "Relu", "tanh": "Tanh", "sigmoid": "Sigmoid",
              "exp": "Exp", "log": "Log", "neg": "Neg", "abs": "Abs",
              "sqrt": "Sqrt", "sign": "Sign", "floor": "Floor",
              "ceil": "Ceil", "erf": "Erf", "reciprocal": "Reciprocal",
              "logical_not": "Not", "bitwise_not": "Not"}
    _BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
               "maximum": "Max", "minimum": "Min", "pow": "Pow",
               "mm": "MatMul", "bmm": "MatMul", "matmul": "MatMul"}
    _COMPARE = {"lt": "Less", "gt": "Greater", "le": "LessOrEqual",
                "ge": "GreaterOrEqual", "eq": "Equal",
                "logical_and": "And", "logical_or": "Or",
                "logical_xor": "Xor"}
    _IDENTITY = {"clone", "alias", "detach", "contiguous", "lift_fresh_copy"}
    _CONSTANT = {"full", "full_like", "zeros", "zeros_like", "ones",
                 "ones_like", "arange", "scalar_tensor", "empty_like"}
    _SKIP = {"_assert_tensor_metadata", "_assert_scalar",
             "sym_constrain_range_for_size", "_assert_async"}

    def __init__(self, g: _Graph):
        self.g = g
        self.names: Dict[Any, Any] = {}

    # -- operands ------------------------------------------------------
    def inp(self, a, like=None) -> str:
        """The ONNX name of argument ``a``: an fx node's value, or a number
        made a constant of ``like``'s type (a literal takes its partner's
        type, as a weakly typed literal does in JAX)."""
        import torch.fx
        if isinstance(a, torch.fx.Node):
            name = self.names[a]
            if name is None:
                raise NotImplementedError(
                    f"ONNX export: the value {a.name} has no ONNX mapping")
            return name
        dtype = _np_dtype(like) if like is not None else np.float32
        if isinstance(a, bool) and like is None:
            dtype = np.bool_
        return self.g.const(np.asarray(a, dtype))

    def shape_const(self, shape) -> str:
        return self.g.const(np.asarray([int(d) for d in shape], np.int64))

    # -- one node ------------------------------------------------------
    def emit(self, node) -> None:
        import operator
        if node.target is operator.getitem:
            src, k = node.args
            outs = self.names[src]
            if outs[k] is None:
                raise NotImplementedError(
                    f"ONNX export: output {k} of {src.target} (pooling "
                    "indices) has no ONNX mapping")
            self.names[node] = outs[k]
            return
        full = str(node.target)
        op = full.split(".")[1] if full.startswith("aten.") else full
        if op in self._SKIP:
            self.names[node] = None
            return
        handler = getattr(self, f"op_{op}", None)
        if handler is not None:
            self.names[node] = handler(node, *node.args, **node.kwargs)
            return
        args = node.args
        g = self.g
        if op in self._UNARY:
            out = g.add(self._UNARY[op], [self.inp(args[0])])[0]
        elif op in self._BINARY and len(args) == 2 and not node.kwargs:
            a, b = args
            like = a if hasattr(a, "meta") else b
            if op == "pow" and not hasattr(b, "meta") and b == 2:
                x = self.inp(a)
                out = g.add("Mul", [x, x])[0]
            else:
                out = g.add(self._BINARY[op], [self.inp(a, like),
                                               self.inp(b, like)])[0]
        elif op in self._COMPARE:
            a, b = args
            like = a if hasattr(a, "meta") else b
            out = g.add(self._COMPARE[op],
                        [self.inp(a, like), self.inp(b, like)])[0]
        elif op == "ne":
            a, b = args
            like = a if hasattr(a, "meta") else b
            e = g.add("Equal", [self.inp(a, like), self.inp(b, like)])[0]
            out = g.add("Not", [e])[0]
        elif op in self._IDENTITY:
            out = g.add("Identity", [self.inp(args[0])])[0]
        elif op in self._CONSTANT:
            shape = tuple(_meta(node).shape)
            arr = np.asarray(self._constant_value(op, node)).astype(
                _np_dtype(node))
            if arr.ndim == 0 and shape:
                # a fill (a ReLU's zeros at an activation's shape): one
                # value expanded, so the file does not grow with the batch
                out = g.add("Expand", [g.const(arr, op),
                                       self.shape_const(shape)])[0]
            else:
                out = g.const(np.ascontiguousarray(
                    np.broadcast_to(arr, shape)), op)
        else:
            raise NotImplementedError(
                f"ONNX export: unsupported ATen op '{full}' (supported: "
                "convolution, pooling, matrix products, elementwise, "
                "reshapes, reductions; extend _Exporter)")
        self.names[node] = out

    def _constant_value(self, op, node):
        args = node.args
        if op == "arange":
            nums = [a for a in args if isinstance(a, (int, float))]
            start, end, step = (0, nums[0], 1) if len(nums) == 1 else (
                nums[0], nums[1], nums[2] if len(nums) > 2 else 1)
            return np.arange(start, end, step)
        if op in ("full", "full_like"):
            return np.asarray(args[1])
        if op == "scalar_tensor":
            return np.asarray(args[0])
        if op in ("zeros", "zeros_like", "empty_like"):
            return np.asarray(0)
        return np.asarray(1)

    # -- ops with their own shape of arguments --------------------------
    def op_permute(self, node, x, dims):
        rank = len(dims)
        return self.g.add("Transpose", [self.inp(x)],
                          perm=[_axis(d, rank) for d in dims])[0]

    def _reshape(self, node, x, *_, **__):
        return self.g.add("Reshape", [self.inp(x), self.shape_const(
            _meta(node).shape)])[0]

    op_view = op_reshape = op__unsafe_view = _reshape
    op_unsqueeze = op_squeeze = _reshape

    def op_convolution(self, node, x, w, b, stride, padding, dilation,
                       transposed, output_padding, groups):
        if transposed:
            raise NotImplementedError(
                "ONNX export: unsupported ATen op 'aten.convolution' with "
                "transposed=True (transposed conv export)")
        g = self.g
        y = g.add("Conv", [self.inp(x), self.inp(w)],
                  strides=list(stride), dilations=list(dilation),
                  group=int(groups), pads=list(padding) + list(padding))[0]
        if b is not None:
            rank = len(_meta(node).shape)
            shape = [1, _meta(b).shape[0]] + [1] * (rank - 2)
            bb = g.add("Reshape", [self.inp(b), self.shape_const(shape)])[0]
            y = g.add("Add", [y, bb])[0]
        return y

    def op_max_pool2d_with_indices(self, node, x, kernel, stride=(),
                                   padding=0, dilation=1, ceil_mode=False):
        kernel = list(kernel)
        stride = list(stride) or kernel
        pad = [padding] * 2 if isinstance(padding, int) else list(padding)
        dil = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
        if ceil_mode or any(d != 1 for d in dil):
            raise NotImplementedError(
                "ONNX export: unsupported ATen op 'aten.max_pool2d_with_"
                "indices' with ceil_mode or dilation")
        y = self.g.add("MaxPool", [self.inp(x)], kernel_shape=kernel,
                       strides=stride, pads=pad + pad)[0]
        return [y, None]

    def op_avg_pool2d(self, node, x, kernel, stride=(), padding=0,
                      ceil_mode=False, count_include_pad=True,
                      divisor_override=None):
        kernel = list(kernel)
        stride = list(stride) or kernel
        pad = [padding] * 2 if isinstance(padding, int) else list(padding)
        if ceil_mode or divisor_override is not None:
            raise NotImplementedError(
                "ONNX export: unsupported ATen op 'aten.avg_pool2d' with "
                "ceil_mode or divisor_override")
        return self.g.add("AveragePool", [self.inp(x)], kernel_shape=kernel,
                          strides=stride, pads=pad + pad,
                          count_include_pad=int(bool(count_include_pad)))[0]

    def op_addmm(self, node, bias, a, b, beta=1, alpha=1):
        g = self.g
        y = g.add("MatMul", [self.inp(a), self.inp(b)])[0]
        if alpha != 1:
            y = g.add("Mul", [y, self.inp(alpha, node)])[0]
        c = self.inp(bias)
        if beta != 1:
            c = g.add("Mul", [c, self.inp(beta, node)])[0]
        return g.add("Add", [y, c])[0]

    def op_rsqrt(self, node, x):
        s = self.g.add("Sqrt", [self.inp(x)])[0]
        return self.g.add("Reciprocal", [s])[0]

    def op_mean(self, node, x, dims=None, keepdim=False, dtype=None):
        """ReduceSum times 1/n: the JAX importer has no ReduceMean."""
        shape = _meta(x).shape
        rank = len(shape)
        axes = list(range(rank)) if not dims else [_axis(d, rank)
                                                   for d in dims]
        n = int(np.prod([shape[d] for d in axes]))
        total = self.g.add("ReduceSum", [self.inp(x), self.g.const(
            np.asarray(axes, np.int64))], keepdims=int(bool(keepdim)))[0]
        return self.g.add("Mul", [total, self.inp(1.0 / n, node)])[0]

    def op_constant_pad_nd(self, node, x, pad, value=0):
        rank = len(_meta(x).shape)
        lo, hi = [0] * rank, [0] * rank
        for i in range(len(pad) // 2):
            lo[rank - 1 - i], hi[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
        return self.g.add("Pad", [self.inp(x), self.g.const(
            np.asarray(lo + hi, np.int64)), self.inp(value, x)])[0]

    def op_where(self, node, c, a, b):
        like = a if hasattr(a, "meta") else b
        return self.g.add("Where", [self.inp(c), self.inp(a, like),
                                    self.inp(b, like)])[0]

    def op_clamp(self, node, x, lo=None, hi=None):
        y = self.inp(x)
        if lo is not None:
            y = self.g.add("Max", [y, self.inp(lo, x)])[0]
        if hi is not None:
            y = self.g.add("Min", [y, self.inp(hi, x)])[0]
        return y

    def op_cat(self, node, tensors, dim=0):
        rank = len(_meta(node).shape)
        return self.g.add("Concat", [self.inp(t) for t in tensors],
                          axis=_axis(dim, rank))[0]

    def op_slice(self, node, x, dim=0, start=None, end=None, step=1):
        size = _meta(x).shape[dim]
        start = 0 if start is None else start
        end = size if end is None else min(end, size)
        rank = len(_meta(x).shape)
        g = self.g
        return g.add("Slice", [
            self.inp(x), g.const(np.asarray([start], np.int64)),
            g.const(np.asarray([end], np.int64)),
            g.const(np.asarray([_axis(dim, rank)], np.int64)),
            g.const(np.asarray([step], np.int64))])[0]

    def op_split_with_sizes(self, node, x, sizes, dim=0):
        rank = len(_meta(x).shape)
        return self.g.add("Split", [self.inp(x), self.g.const(
            np.asarray(sizes, np.int64))], n_out=len(sizes),
            axis=_axis(dim, rank))

    def op_embedding(self, node, weight, indices, *_):
        return self.g.add("Gather", [self.inp(weight), self.inp(indices)],
                          axis=0)[0]

    def op__softmax(self, node, x, dim, half_to_float=False):
        rank = len(_meta(x).shape)
        return self.g.add("Softmax", [self.inp(x)], axis=_axis(dim, rank))[0]

    def op_gelu(self, node, x, approximate="none"):
        g = self.g
        xn = self.inp(x)
        if approximate == "tanh":
            x3 = g.add("Mul", [g.add("Mul", [xn, xn])[0], xn])[0]
            inner = g.add("Add", [xn, g.add("Mul", [
                x3, self.inp(0.044715, x)])[0]])[0]
            t = g.add("Tanh", [g.add("Mul", [
                inner, self.inp(float(np.sqrt(2 / np.pi)), x)])[0]])[0]
        else:
            t = g.add("Erf", [g.add("Div", [
                xn, self.inp(float(np.sqrt(2.0)), x)])[0]])[0]
        one = g.add("Add", [t, self.inp(1.0, x)])[0]
        return g.add("Mul", [g.add("Mul", [xn, self.inp(0.5, x)])[0],
                             one])[0]


class _NHWCInputs(torch.nn.Module):
    """The exported callable: a 4-d input arrives NHWC, as the JAX export's
    graph input does, and the port model gets its NCHW view."""

    def __init__(self, model, kwargs):
        super().__init__()
        self.model = model
        self.kwargs = kwargs

    def forward(self, *args):
        args = [a.permute(0, 3, 1, 2) if a.dim() == 4 else a for a in args]
        return self.model(*args, **self.kwargs)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _example(a) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    return t.detach().cpu()


def export_onnx(model_or_fn, *example_args, path: Optional[str] = None,
                variables=None, opset: int = 13,
                training: bool = False) -> bytes:
    """Export a port model (or a torch callable) to ONNX bytes.

    A model is traced from a CPU copy (the card's kernels are ctypes calls
    ``torch.export`` cannot trace, and a file carries no device), in eval
    mode, with ``variables`` (a JAX-layout ``{"params", "batch_stats"}``
    tree) loaded into the copy when given.  Its 4-d inputs are NHWC, as
    the JAX export's are; a plain callable gets its inputs as given.
    Shapes are baked at the examples' batch; the weights become
    initializers."""
    import copy
    import inspect

    if isinstance(model_or_fn, torch.nn.Module):
        model = copy.deepcopy(model_or_fn).cpu().eval()
        if variables is not None:
            from dt_tpu_torch.interchange import load_jax_variables
            load_jax_variables(model, variables)
        kwargs = {}
        if "training" in inspect.signature(model.forward).parameters:
            kwargs["training"] = training
        module = _NHWCInputs(model, kwargs)
    else:
        module = _Fn(model_or_fn)
    args = tuple(_example(a) for a in example_args)
    with torch.no_grad():
        ep = torch.export.export(module, args).run_decompositions()
    return _emit(ep, args, path, opset)


def _emit(ep, args, path, opset) -> bytes:
    from torch.export.graph_signature import InputKind

    g = _Graph()
    ex = _Exporter(g)
    inputs, user = [], 0
    consts = dict(ep.state_dict)
    consts.update(getattr(ep, "constants", {}) or {})
    specs = {s.arg.name: s for s in ep.graph_signature.input_specs}
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = specs[node.name]
            if spec.kind == InputKind.USER_INPUT:
                nm = f"input_{user}"
                a = args[user]
                user += 1
                inputs.append(_value_info(
                    nm, tuple(a.shape), _TORCH_TO_NP.get(a.dtype,
                                                         np.float32)))
                ex.names[node] = nm
            else:
                value = consts[spec.target].detach()
                if value.dtype == torch.bfloat16:
                    value = value.float()
                nm = spec.target
                g.initializers.append(_tensor_proto(nm, value.cpu().numpy()))
                ex.names[node] = nm
        elif node.op == "call_function":
            ex.emit(node)
        elif node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            outputs = []
            for o in outs:
                val = _meta(o)
                outputs.append(_value_info(ex.inp(o), tuple(val.shape),
                                           _TORCH_TO_NP.get(val.dtype,
                                                            np.float32)))
        else:
            raise NotImplementedError(
                f"ONNX export: unsupported fx node {node.op} {node.target}")

    graph = b"".join(_len_delim(1, n) for n in g.nodes)
    graph += _str_field(2, "dt_tpu_export")
    graph += b"".join(_len_delim(5, t) for t in g.initializers)
    graph += b"".join(_len_delim(11, vi) for vi in inputs)
    graph += b"".join(_len_delim(12, vi) for vi in outputs)
    model_bytes = _model_proto(graph, opset)
    if path:
        with open(path, "wb") as f:
            f.write(model_bytes)
    return model_bytes


# ----------------------------------------------------------------------
# ONNX -> torch executor
# ----------------------------------------------------------------------


def parse_model(model_bytes: bytes) -> dict:
    """Decode ModelProto -> {nodes, initializers, inputs, outputs, opset}."""
    graph = None
    opset = 0
    for field, val in _Reader(model_bytes):
        if field == 7:
            graph = val
        elif field == 8:
            for f2, v2 in _Reader(val):
                if f2 == 2:
                    opset = max(opset, _signed(v2))
    if graph is None:
        raise ValueError("no GraphProto in model")
    out = {"nodes": [], "initializers": {}, "inputs": [], "outputs": [],
           "opset": opset}
    for field, val in _Reader(graph):
        if field == 1:
            out["nodes"].append(_parse_node(val))
        elif field == 5:
            name, arr = _parse_tensor(val)
            out["initializers"][name] = arr
        elif field == 11:
            out["inputs"].append(_parse_value_info(val))
        elif field == 12:
            out["outputs"].append(_parse_value_info(val))
    return out


#: JAX's 32-bit canonical types (the JAX package runs without x64): a
#: 64-bit operand computes as its 32-bit type
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}
_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.bool_): torch.bool,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float64}


def _promote(*ts):
    """The operands in one type, as ``jnp`` promotes arrays: 64-bit types
    first canonicalized to 32 bits."""
    dtype = _CANONICAL.get(ts[0].dtype, ts[0].dtype)
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, _CANONICAL.get(t.dtype, t.dtype))
    return [t.to(dtype) for t in ts]


def _binary(fn):
    return lambda a, b: fn(*_promote(a, b))


def _cast_type(code: int) -> torch.dtype:
    """The torch type an ONNX ``Cast`` makes in the JAX importer: unknown
    codes give float32 and 64-bit types their 32-bit canonical type."""
    t = _NP_TO_TORCH[_ONNX_TO_NP.get(code, np.dtype(np.float32))]
    return _CANONICAL.get(t, t)


def _pad(x, pads_lo, pads_hi, value=0.0):
    """Explicit padding of the trailing ``len(pads_lo)`` axes (``F.pad``
    order: last axis first)."""
    flat = []
    for lo, hi in zip(reversed(pads_lo), reversed(pads_hi)):
        flat += [int(lo), int(hi)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, k, strides):
    """Sum over each window (no padding), by average pooling with a
    divisor of 1; 1-d goes through 2-d."""
    if len(k) == 1:
        return _window_sum(x.unsqueeze(-2), [1, k[0]],
                           [1, strides[0]]).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, k, strides, divisor_override=1)


def _reduce(fn, x, axes, keep):
    if axes is None:
        axes = tuple(range(x.dim()))
    axes = sorted({a % x.dim() for a in axes}, reverse=True)
    for a in axes:
        x = fn(x, a, keepdim=True)
    if not keep:
        for a in axes:
            x = x.squeeze(a)
    return x


def _take(x, idx, axis):
    """``jnp.take``: negative indices count from the end."""
    axis = axis % x.dim()
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _slice(x, starts, ends, axes, steps):
    for s, e, ax, st in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        keep = list(range(x.shape[ax]))[slice(s, e, st)]
        if st == 1 and keep:
            x = x.narrow(ax, keep[0], len(keep))
        else:
            x = torch.index_select(x, ax, torch.as_tensor(
                keep, dtype=torch.long, device=x.device))
    return x


def _run_node(node: dict, ins: List, static: List = None):
    """One ONNX node on torch tensors.  ``static`` carries the numpy value
    of every input that is a graph initializer: shape, pad and axis
    operands are read from it, never from the device."""
    op = node["op_type"]
    a = node["attrs"]
    static = static or [None] * len(ins)

    def shp(k):
        v = static[k] if static[k] is not None else ins[k].cpu().numpy()
        return [int(d) for d in np.asarray(v)]
    e1 = {"Relu": torch.relu, "Sigmoid": torch.sigmoid,
          "Tanh": torch.tanh, "Exp": torch.exp, "Log": torch.log,
          "Neg": torch.neg, "Abs": torch.abs, "Sqrt": torch.sqrt,
          "Reciprocal": lambda x: 1.0 / x, "Sign": torch.sign,
          "Floor": torch.floor, "Ceil": torch.ceil,
          "Erf": torch.erf, "Identity": lambda x: x}
    e2 = {"Add": _binary(torch.add), "Sub": _binary(torch.sub),
          "Mul": _binary(torch.mul), "Div": _binary(torch.true_divide),
          "Max": _binary(torch.maximum), "Min": _binary(torch.minimum),
          "Pow": _binary(torch.pow), "MatMul": _binary(torch.matmul)}
    if op in e1:
        return [e1[op](ins[0])]
    if op in e2:
        return [e2[op](ins[0], ins[1])]
    if op == "Cast":
        return [ins[0].to(_cast_type(a["to"]))]
    if op == "Reshape":
        return [torch.reshape(ins[0], shp(1))]
    if op == "Transpose":
        return [ins[0].permute(*a["perm"])]
    if op == "Expand":
        return [ins[0].expand(shp(1))]
    if op == "Concat":
        return [torch.cat(_promote(*ins), dim=a["axis"])]
    if op == "Where":
        x, y = _promote(ins[1], ins[2])
        return [torch.where(ins[0].bool(), x, y)]
    if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
        axes = a.get("axes")
        if axes is None and len(ins) > 1:
            axes = shp(1)
        keep = bool(a.get("keepdims", 1))
        x = ins[0]
        if axes is not None and len(axes) == 0:
            return [x]
        if op == "ReduceSum":
            dims = tuple(range(x.dim())) if axes is None else tuple(axes)
            return [torch.sum(x, dim=dims, keepdim=keep)]
        if op == "ReduceMax":
            return [torch.amax(x, dim=tuple(range(x.dim())) if axes is None
                               else tuple(axes), keepdim=keep)]
        if op == "ReduceMin":
            return [torch.amin(x, dim=tuple(range(x.dim())) if axes is None
                               else tuple(axes), keepdim=keep)]
        return [_reduce(torch.prod, x, axes, keep)]
    if op in ("ArgMax", "ArgMin"):
        fn = torch.argmax if op == "ArgMax" else torch.argmin
        return [fn(ins[0], dim=a.get("axis", 0),
                   keepdim=bool(a.get("keepdims", 1))).to(torch.int32)]
    if op == "Conv":
        x, w = ins[0], ins[1]
        if x.dtype != w.dtype:
            raise TypeError(
                f"ONNX import: Conv needs one dtype for its input and its "
                f"weights (as lax.conv_general_dilated does), got "
                f"{x.dtype} and {w.dtype}")
        nsp = x.dim() - 2
        pads = a.get("pads") or [0] * 2 * nsp
        lo, hi = pads[:nsp], pads[nsp:]
        if lo == hi:
            pad = tuple(lo)
        else:
            x, pad = _pad(x, lo, hi), 0
        return [_CONV[nsp](x, w, None, tuple(a.get("strides", [1] * nsp)),
                           pad, tuple(a.get("dilations", [1] * nsp)),
                           a.get("group", 1))]
    if op in ("MaxPool", "AveragePool"):
        k = list(a["kernel_shape"])
        nsp = len(k)
        strides = list(a.get("strides", [1] * nsp))
        pads = a.get("pads", [0] * 2 * nsp)
        x = ins[0]
        if op == "MaxPool":
            fill = float("-inf") if x.is_floating_point() else \
                torch.iinfo(x.dtype).min
            x = _pad(x, pads[:nsp], pads[nsp:], fill)
            return [_MAXPOOL[nsp](x, k, strides)]
        s = _window_sum(_pad(x, pads[:nsp], pads[nsp:]), k, strides)
        if a.get("count_include_pad", 0):
            return [s / float(np.prod(k))]
        ones = _pad(torch.ones_like(ins[0]), pads[:nsp], pads[nsp:])
        return [s / _window_sum(ones, k, strides)]
    if op == "Pad":
        pads = shp(1)
        nd = ins[0].dim()
        # the pad value must be static (the export emits it as an
        # initializer); a computed one counts as 0, as in the JAX importer
        cval = 0.0
        if len(ins) > 2 and static[2] is not None:
            cval = np.asarray(static[2]).item()
        return [_pad(ins[0], pads[:nd], pads[nd:], cval)]
    if op == "Einsum":
        return [torch.einsum(a["equation"], *_promote(*ins))]
    c2 = {"Less": torch.lt, "Greater": torch.gt, "LessOrEqual": torch.le,
          "GreaterOrEqual": torch.ge, "Equal": torch.eq,
          "And": torch.logical_and, "Or": torch.logical_or,
          "Xor": torch.logical_xor}
    if op in c2:
        return [c2[op](*_promote(ins[0], ins[1]))]
    if op == "Not":
        return [torch.logical_not(ins[0])]
    if op == "Gather":
        return [_take(ins[0], ins[1], a.get("axis", 0))]
    if op == "Slice":
        starts = shp(1)
        ends = shp(2)
        axes = shp(3) if len(ins) > 3 else list(range(ins[0].dim()))
        steps = shp(4) if len(ins) > 4 else [1] * len(starts)
        return [_slice(ins[0], starts, ends, axes, steps)]
    if op == "Split":
        return list(torch.split(ins[0], shp(1), dim=a.get("axis", 0)))
    if op == "Gemm":
        y = torch.matmul(*_promote(ins[0].T if a.get("transA") else ins[0],
                                   ins[1].T if a.get("transB") else ins[1]))
        y = y * a.get("alpha", 1.0)
        if len(ins) > 2:
            y = y + ins[2] * a.get("beta", 1.0)
        return [y]
    if op == "Softmax":
        return [torch.softmax(ins[0], dim=a.get("axis", -1))]
    if op == "Flatten":
        ax = a.get("axis", 1)
        return [torch.reshape(ins[0],
                              (int(np.prod(ins[0].shape[:ax])), -1))]
    raise NotImplementedError(f"ONNX import: unsupported op {op}")


def _input(x) -> torch.Tensor:
    """A graph input as a tensor: numpy arrays as ``jnp.asarray`` makes
    them (64-bit types become 32-bit), tensors as they are."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t.to(_CANONICAL.get(t.dtype, t.dtype))


def import_onnx(model_bytes_or_path):
    """ONNX -> ``(fn, params)``: ``params`` maps every initializer to a CPU
    tensor, and ``fn(params, *inputs)`` runs the node list with torch ops
    on the device of the first input (move ``params`` there once to keep
    the weights on the card)."""
    if isinstance(model_bytes_or_path, str):
        with open(model_bytes_or_path, "rb") as f:
            model_bytes = f.read()
    else:
        model_bytes = model_bytes_or_path
    m = parse_model(model_bytes)
    initializers = {k: np.asarray(v) for k, v in m["initializers"].items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in initializers.items()}
    input_names = [n for n, _, _ in m["inputs"] if n not in params]
    output_names = [n for n, _, _ in m["outputs"]]
    nodes = m["nodes"]

    def fn(params, *inputs):
        inputs = [_input(x) for x in inputs]
        dev = inputs[0].device if inputs else torch.device("cpu")
        env = {k: v.to(dev) for k, v in params.items()}
        for nm, x in zip(input_names, inputs):
            env[nm] = x.to(dev)
        for node in nodes:
            in_names = [nm for nm in node["input"] if nm]
            ins = [env[nm] for nm in in_names]
            static = [initializers.get(nm) for nm in in_names]
            outs = _run_node(node, ins, static)
            for nm, val in zip(node["output"], outs):
                env[nm] = val
        res = [env[nm] for nm in output_names]
        return res[0] if len(res) == 1 else tuple(res)

    return fn, params
