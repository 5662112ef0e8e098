"""Initializers of the port (counterpart of ``dt_tpu/initializer.py``).

Reference: ``python/mxnet/initializer.py`` — Zero, One, Constant, Uniform,
Normal, Orthogonal, Xavier (rnd_type gaussian|uniform, factor_type
in|out|avg, magnitude), MSRAPrelu, Bilinear (deconv upsampling), Mixed
(pattern dispatch).  Each returns ``init(generator, shape, dtype)``, a CPU
tensor drawn from the explicit ``torch.Generator``, for a shape in the JAX
layout (a conv kernel HWIO, a dense kernel ``(in, out)``), which is what
the fans are computed from.  The JAX package draws from ``jax.random``, so
the values differ and only the distributions match
(``tests/test_torch_initializer.py``).

``lecun_normal`` (linen's default kernel init) and ``embed_normal`` (linen's
default ``Embed`` init) serve ``models.init_params``, the port's default
initialization of a model.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

InitFn = Callable[..., torch.Tensor]
Shape = Sequence[int]

# the std of a standard normal truncated to [-2, 2] (linen's variance_scaling
# divides by it so that the truncated draw keeps the asked-for variance)
_TRUNC_STD = 0.87962566103423978


def zeros() -> InitFn:
    return lambda gen, shape, dtype=torch.float32: torch.zeros(
        tuple(shape), dtype=dtype)


def ones() -> InitFn:
    return lambda gen, shape, dtype=torch.float32: torch.ones(
        tuple(shape), dtype=dtype)


def constant(value: float) -> InitFn:
    return lambda gen, shape, dtype=torch.float32: torch.full(
        tuple(shape), float(value), dtype=dtype)


def _uniform(gen, shape: Shape, lo: float, hi: float, dtype) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (u * (hi - lo) + lo).to(dtype)


def _normal(gen, shape: Shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
            * std).to(dtype)


def uniform(scale: float = 0.07) -> InitFn:
    return lambda gen, shape, dtype=torch.float32: _uniform(
        gen, shape, -scale, scale, dtype)


def normal(sigma: float = 0.01) -> InitFn:
    return lambda gen, shape, dtype=torch.float32: _normal(
        gen, shape, sigma, dtype)


def orthogonal(scale: float = 1.414, rand_type: str = "uniform") -> InitFn:
    """``jax.nn.initializers.orthogonal(scale)`` (the JAX package ignores
    ``rand_type`` too): the Q of a normal matrix's QR, its columns signed by
    R's diagonal, over the last axis as columns."""
    def init(gen, shape, dtype=torch.float32):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                        generator=gen, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.t()
        return (q.reshape(shape) * scale).to(dtype)
    return init


def _fans(shape: Shape) -> Tuple[float, float]:
    """fan_in/fan_out with conv receptive-field scaling (reference
    ``Xavier._init_weight``, for HWIO kernels)."""
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    if len(shape) == 4:  # HWIO
        rf = shape[0] * shape[1]
        return float(shape[2] * rf), float(shape[3] * rf)
    n = float(np.prod(shape))
    return n, n


def xavier(rnd_type: str = "uniform", factor_type: str = "avg",
           magnitude: float = 3.0) -> InitFn:
    """Reference ``mx.init.Xavier``."""
    if rnd_type not in ("uniform", "gaussian"):
        raise ValueError(rnd_type)
    if factor_type not in ("in", "out", "avg"):
        raise ValueError(factor_type)

    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        factor = {"in": fan_in, "out": fan_out,
                  "avg": (fan_in + fan_out) / 2.0}[factor_type]
        scale = float(np.sqrt(magnitude / max(factor, 1.0)))
        if rnd_type == "uniform":
            return _uniform(gen, shape, -scale, scale, dtype)
        return _normal(gen, shape, scale, dtype)
    return init


def msra_prelu(factor_type: str = "avg", slope: float = 0.25) -> InitFn:
    """Reference ``mx.init.MSRAPrelu``: Xavier-gaussian with magnitude
    2/(1+slope²)."""
    return xavier("gaussian", factor_type, 2.0 / (1.0 + slope ** 2))


def bilinear() -> InitFn:
    """Bilinear upsampling kernel for deconv (reference
    ``mx.init.Bilinear``); shape (kh, kw, in_c, out_c) HWIO.  Draws
    nothing."""
    def init(gen, shape, dtype=torch.float32):
        kh, kw = shape[0], shape[1]
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(tuple(shape), np.float32)
        for y in range(kh):
            for x in range(kw):
                val = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
                for ch in range(min(shape[2], shape[3])):
                    w[y, x, ch, ch] = val
        return torch.from_numpy(w).to(dtype)
    return init


def mixed(patterns: Sequence[str], initializers: Sequence[InitFn]
          ) -> Callable:
    """Pattern dispatch by param name (reference ``mx.init.Mixed``):
    returns ``init(name, generator, shape, dtype)``."""
    compiled = [re.compile(p) for p in patterns]

    def init(name: str, gen, shape, dtype=torch.float32):
        for pat, fn in zip(compiled, initializers):
            if pat.search(name):
                return fn(gen, shape, dtype)
        raise ValueError(f"no initializer pattern matched {name!r}")
    return init


def lecun_normal() -> InitFn:
    """linen's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a standard normal truncated to [-2, 2], times
    ``sqrt(1 / fan_in) / 0.8796`` (the truncated draw's own std), fan_in
    the product of every axis but the last (HWI of a conv kernel)."""
    def init(gen, shape, dtype=torch.float32):
        fan_in = float(np.prod(shape[:-1])) if len(shape) > 1 else \
            float(shape[0])
        t = torch.empty(tuple(shape), dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(dtype)
    return init


def embed_normal() -> InitFn:
    """linen's default ``Embed`` init, ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)`` of a ``(V, D)`` table: normal with std
    ``1 / sqrt(D)``."""
    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, 1.0 / math.sqrt(shape[-1]), dtype)
    return init


_REGISTRY: Dict[str, Callable[..., InitFn]] = {
    "zeros": zeros,
    "ones": ones,
    "constant": constant,
    "uniform": uniform,
    "normal": normal,
    "orthogonal": orthogonal,
    "xavier": xavier,
    "msra_prelu": msra_prelu,
    "bilinear": bilinear,
}


def create(name: str, **kwargs) -> InitFn:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown initializer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
