"""Custom operators written in numpy (counterpart of
``dt_tpu/ops/custom.py``).

Reference: ``src/operator/custom/custom.cc`` + ``python/mxnet/operator.py``
(``CustomOp``/``CustomOpProp``): a user forward and backward in
Python/numpy, called from the graph, with declared output shapes.  Here the
op is a ``torch.autograd.Function``: its forward copies the inputs to the
host, calls the user's ``forward`` and puts the results back on the inputs'
device; its backward does the same with the user's ``backward``.  Output
shapes come from ``infer_shape`` (default: the first input's), dtypes from
``infer_dtype`` (default: the first input's), as the JAX function declares
them; the host arrays are reshaped and cast to them.

    def fwd(x, w):                 # numpy in, numpy out
        return x @ w,
    def bwd(inputs, outputs, gys): # -> per-input grads
        x, w = inputs
        (gy,) = gys
        return gy @ w.T, x.T @ gy
    op = custom_op(fwd, bwd, infer_shape=lambda x, w: [(x[0], w[1])])
    y = op(x, w)                   # gradients flow through bwd
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def _np_dtype(dtype) -> np.dtype:
    """A torch or numpy dtype as numpy's."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def custom_op(forward: Callable, backward: Optional[Callable] = None,
              infer_shape: Optional[Callable] = None,
              infer_dtype: Optional[Callable] = None,
              name: str = "custom"):
    """Wrap numpy ``forward``/``backward`` as a differentiable op.

    ``forward(*arrays) -> tuple of arrays``; ``backward(inputs, outputs,
    out_grads) -> tuple of input grads`` (None: the outputs carry no
    gradient); ``infer_shape(*input_shapes) -> [output shapes]``;
    ``infer_dtype(*input_dtypes) -> [output dtypes]`` (numpy dtypes in,
    numpy or torch dtypes out).  One output comes back as a tensor, several
    as a tuple."""

    def result_specs(args) -> Sequence[Tuple[tuple, np.dtype]]:
        shapes = [tuple(a.shape) for a in args]
        out_shapes = (infer_shape(*shapes) if infer_shape is not None
                      else [shapes[0]])
        dtypes = [_np_dtype(a.dtype) for a in args]
        out_dtypes = (infer_dtype(*dtypes) if infer_dtype is not None
                      else [dtypes[0]] * len(out_shapes))
        return [(tuple(s), _np_dtype(d))
                for s, d in zip(out_shapes, out_dtypes)]

    def call_forward(args):
        specs = result_specs(args)
        outs = forward(*[_host(a) for a in args])
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(specs):
            raise ValueError(f"{name}: forward returned {len(outs)} outputs "
                             f"but infer_shape declared {len(specs)}")
        dev = args[0].device
        return tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(o, dtype=d).reshape(s))).to(dev)
            for o, (s, d) in zip(outs, specs))

    def unwrap(outs):
        return outs[0] if len(outs) == 1 else outs

    if backward is None:
        def simple(*args):
            return unwrap(call_forward(args))
        simple.__name__ = name
        return simple

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            outs = call_forward(args)
            ctx.save_for_backward(*args, *outs)
            ctx.n_in = len(args)
            return outs

        @staticmethod
        def backward(ctx, *gys):
            saved = ctx.saved_tensors
            args, outs = saved[:ctx.n_in], saved[ctx.n_in:]
            grads = backward(tuple(_host(a) for a in args),
                             tuple(_host(o) for o in outs),
                             tuple(_host(g) for g in gys))
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            return tuple(
                torch.from_numpy(np.ascontiguousarray(
                    np.asarray(g, dtype=_np_dtype(a.dtype))
                    .reshape(tuple(a.shape)))).to(a.device)
                if a.is_floating_point() else None
                for g, a in zip(grads, args))

    _Op.__name__ = name

    def op(*args):
        return unwrap(_Op.apply(*args))
    op.__name__ = name
    return op
